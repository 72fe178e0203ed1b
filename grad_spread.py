#!/usr/bin/env python3
"""How far the pretrain step's gradients on the card lie from the CPU's,
against how far the CPU's own lie from themselves when the image input
moves by 1e-6 relative.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 grad_spread.py [--batches 12]

The model and the batches are those of ``chip_smoke.py`` phase 8's
card-against-CPU check: the full-width pretrain model from seed 0, dropout
0, the attention-supervision loss on, B=8 batches of the synthetic data
module built one at a time (one builder), preceded by phase 7's batch.
For each batch it prints, over the tensors outside the ResNet:

- card against CPU, and the CPU against itself on the moved input: the
  relative L2 over all those tensors, the worst three tensors by
  ||diff|| / (||g|| + 1e-6 sqrt(n)) and the worst max|diff| / (1e-3
  max|g| + 1e-6);
- card against CPU: the image and word features (max|diff| / max|x| and
  relative L2), the loss's gradient with respect to them, and the BERT
  tower's parameter gradients given the CPU's gradient with respect to the
  word features on both sides.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys

import torch

import chip_smoke as cs


def _rel(a: torch.Tensor, b: torch.Tensor) -> str:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    d = a - b
    return f"{float(d.abs().max() / b.abs().max()):.2e}/{float(d.norm() / b.norm()):.2e}"


def _step(model, batch: dict, imgs: torch.Tensor | None = None):
    """``train.loss_and_grads``, also returning the features and the loss's
    gradient with respect to them."""
    params = list(model.parameters())
    model.train()
    if imgs is not None:
        batch = dict(batch, imgs=imgs)
    feats = model(batch)
    grid = feats[4]
    loss, metrics, _ = model.calc_loss(*feats[:4], batch["cap_lens"], grid,
                                       batch.get("segmentation_labels"))
    wrt = params + list(feats[:4])
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, wrt)]
    return metrics, grads[:len(params)], feats[:4], grads[len(params):]


def _spread(names: list[str], ga: list, ca: list) -> str:
    rows, da, db = [], [], []
    for n, a, b in zip(names, ga, ca):
        if n.startswith(cs.BACKBONE):
            continue
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        d = a - b
        rows.append((float(d.norm()) / (float(b.norm()) + 1e-6 * b.numel() ** 0.5),
                     float(d.abs().max()) / (1e-3 * float(b.abs().max()) + 1e-6), n))
        da.append(d.flatten())
        db.append(b.flatten())
    rows.sort(reverse=True)
    total = float(torch.cat(da).norm() / torch.cat(db).norm())
    return (f"relative L2 over all {total:.2e}; worst tensors " + ", ".join(
        f"{n.removeprefix('text_encoder.model.')} {r:.2e}" for r, _, n in rows[:3])
        + f"; worst max|diff| / (1e-3 max|g| + 1e-6) {max(r[1] for r in rows):.3f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, default=12, help="loader batches after phase 7's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("grad_spread: no CUDA device", file=sys.stderr)
        return 2
    from gloria_tpu_torch.data.data_module import build_data_module
    from gloria_tpu_torch.data.synthetic import make_synthetic_batch
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.training import train
    from gloria_tpu_torch.utils import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    cuda_build.build(["local_sim_fwd", "local_sim_bwd"])
    cfg = cs.loader_config(8, dropout=0.0)
    cfg.train.num_workers = 1
    loader = build_data_module(cfg, device="cpu").loader("train", prefetch=1)
    batches = [make_synthetic_batch(batch_size=8, num_tokens=97, imsize=224, vocab_size=28996,
                                    seed=1)]
    while len(batches) <= args.batches:  # epochs of 8 batches, one after another
        for b in loader:
            batches.append(b)
            if len(batches) > args.batches:
                break
    cpu_model = init_gloria(cfg, seed=0)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    names = [n for n, _ in cpu_model.named_parameters()]
    text = [i for i, n in enumerate(names) if n.startswith("text_encoder.")]
    gen = torch.Generator().manual_seed(0)
    for i, raw in enumerate(batches):
        raw = train.to_device(raw, torch.device("cpu"))
        dev = train.to_device(raw, torch.device("cuda"))
        gm, gg, gfeat, gup = _step(gpu_model, dev)
        cm, cg, cfeat, cup = _step(cpu_model, raw)
        x = raw["imgs"]
        if x.dtype == torch.uint8:
            x = x.float().expand(*x.shape[:-1], 3)
            x = (x / 255.0 - cpu_model.norm_mean) / cpu_model.norm_std
        moved = x.contiguous() * (1 + 1e-6 * torch.randn(x.shape, generator=gen))
        _, mg, _, _ = _step(cpu_model, raw, moved)
        # the BERT tower alone, the same upstream gradient on both sides
        ids = ("caption_ids", "attention_mask", "token_type_ids", "word_assignment")
        cp, gp = list(cpu_model.parameters()), list(gpu_model.parameters())
        c_out = cpu_model.text_encoder_forward(*(raw.get(k) for k in ids))
        g_out = gpu_model.text_encoder_forward(*(dev.get(k) for k in ids))
        ct = torch.autograd.grad(c_out, [cp[j] for j in text], cup[2:], allow_unused=True)
        gt = torch.autograd.grad(g_out, [gp[j] for j in text], [u.cuda() for u in cup[2:]],
                                 allow_unused=True)
        pairs = [(a, b) for a, b in zip(gt, ct) if b is not None]
        bert = max(float((a.cpu() - b).abs().max()) / (1e-3 * float(b.abs().max()) + 1e-6)
                   for a, b in pairs)
        what = "phase 7's batch" if i == 0 else f"loader batch {i - 1}"
        print(f"--- {what}: loss {float(cm['loss']):.6f}, card {float(gm['loss']):.6f}", flush=True)
        print(f"  card vs cpu: {_spread(names, gg, cg)}")
        print(f"  cpu, input moved 1e-6 relative, vs cpu: {_spread(names, mg, cg)}")
        print("  card vs cpu, max|diff| / max|x| / relative L2 of img_l, img_g, words, sentence: "
              + ", ".join(_rel(a, b) for a, b in zip(gfeat, cfeat)) + "; of the loss's gradient "
              "with respect to them: " + ", ".join(_rel(a, b) for a, b in zip(gup, cup)))
        print(f"  BERT alone, the same upstream gradient: worst max|diff| / (1e-3 max|g| + 1e-6) "
              f"{bert:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
