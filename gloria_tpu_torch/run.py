"""Experiment driver of the port: config + CLI overrides → train / validate / test.

The counterpart of the JAX package's ``run.py``, with the same flags:

    python -m gloria_tpu_torch.run -c configs/chexpert_pretrain_config.yaml --train
    python -m gloria_tpu_torch.run -c <cfg> --train --test --device cpu
    python -m gloria_tpu_torch.run -c <cfg> --train --resume --ckpt <step dir>
    python -m gloria_tpu_torch.run -c configs/chexpert_classification_config.yaml \
        --ckpt <pretrain step dir> --train --test

It runs on the CUDA card unless ``--device`` names another (the port's
counterpart of ``JAX_PLATFORMS=cpu``).  Each seed gets an output directory
``<output_dir>/<experiment_name>_<stamp>`` holding the resolved
``config.yaml`` (JSON, which YAML readers read too), the metric files and
``ckpt/`` (``training.checkpoints``); ``<output_dir>/best_ckpts.yaml`` maps
each seed to its best checkpoint and is written before anything is printed.
``--ckpt`` warm-starts from a checkpoint of the port; with ``--resume`` it
also restores the optimizer state, the step and the trainer's state (epoch,
scheduler, early stopping).  ``--fused_kernel`` is accepted: the port's
local loss always runs the K1/K2 kernels on a card.  Precision 32 is the
only one ported: on a card the driver turns TF32 off for cuDNN and cuBLAS.

The ImaGenome grounding configs run in the pretrain phase:
``lightning.evaluate_localization`` scores the attention of the train
(every ``log_train_every`` batches), validation and test steps against the
boxes and writes ``<run dir>/localization/<split>/sentences.csv``, with the
full artifacts when ``data.gold_test``;
``lightning.weight_instances_by_localization`` reweights the training
instances each epoch; either makes the train step return its attention.
The data ablation flags (``--randomize_reports``, ``--swap_left_right``,
...) reach the ``imagenome`` data module:

    python -m gloria_tpu_torch.run -c configs/imagenome_attn_finetune_config.yaml \
        --ckpt <pretrain step dir> --train --test
    python -m gloria_tpu_torch.run -c configs/imagenome_pretrain_val_config.yaml \
        --ckpt <step dir> --test [--swap_left_right]

The ``classification`` and ``segmentation`` phases train a task model
(``builder.init_task``): ``--ckpt`` names a pretrain checkpoint whose image
encoder is grafted in (the whole ``img_encoder`` into the classifier, its
backbone into the U-Net), ``model.vision.freeze_cnn`` freezes it, and the
epoch metrics are ``val_auroc`` / ``val_auprc`` or ``val_dice`` (also on
the test split, under the JAX driver's names).  With ``--resume``, ``--ckpt``
is instead a checkpoint of the task itself, continued as in the pretrain
phase (the JAX driver ignores ``--resume`` in the task phases).  The
classification test results also go to ``<run dir>/results.csv``, as the
reference writes them; the segmentation phase writes its first validation
sample's images (``training.tasks.LogSegmentationSamples``).

Options the port does not take yet raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them (:func:`refuse_unported`).  ``main``'s
result holds, under ``"run"``, where the time went, the kernel launches of
the run and each checkpoint save; the CLI prints it as one ``[run]`` line of
JSON before the results.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from pathlib import Path

import numpy as np

from .configs import Config, dumps_json, load_config, save_config

PHASES = ("pretrain", "classification", "segmentation")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gloria_tpu_torch experiment driver")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--val", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--ckpt", default=None, help="checkpoint dir to warm-start or resume from")
    p.add_argument("--resume", action="store_true", help="resume optimizer state from --ckpt")
    p.add_argument("--random_seed", type=int, default=None)
    p.add_argument("--train_pct", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--randomize_reports", action="store_true")
    p.add_argument("--randomize_objects_mode", default=None,
                   choices=["random_bboxes", "random_sentences", "shuffle"])
    p.add_argument("--swap_left_right", action="store_true")
    p.add_argument("--swap_conditions", action="store_true")
    p.add_argument("--generate_sent", action="store_true")
    p.add_argument("--mask_mode", default=None,
                   choices=["word", "sentence", "entity", "clinical_entity"])
    p.add_argument("--mask_prob", type=float, default=None)
    p.add_argument("--no_attn_vec", action="store_true")
    p.add_argument("--no_attn_loss_weight", type=float, default=None)
    p.add_argument("--attention_divergence_loss_weight", type=float, default=None)
    p.add_argument("--attention_entropy_loss_weight", type=float, default=None)
    p.add_argument("--segmentation_loss_weight", type=float, default=None)
    p.add_argument("--limit_batches", type=int, default=None, help="cap batches/epoch (debug)")
    p.add_argument("--fused_kernel", action="store_true",
                   help="accepted; the port's local loss always runs the K1/K2 kernels on a card")
    p.add_argument("--profile", type=int, default=None, metavar="N",
                   help="torch.profiler trace of N train steps to <output_dir>/profile")
    p.add_argument("--accumulate_grad_batches", type=int, default=None,
                   help="not ported yet (ROADMAP.md A1.8)")
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="not ported yet (ROADMAP.md A1.8)")
    p.add_argument("--loss_chunk", type=int, default=None,
                   help="not ported yet (ROADMAP.md A1.8)")
    p.add_argument("--fsdp", type=int, default=1, help="not ported yet above 1 (ROADMAP.md A7)")
    p.add_argument("--tp", type=int, default=1, help="not ported yet above 1 (ROADMAP.md A7)")
    p.add_argument("--multihost", action="store_true", help="not ported yet (ROADMAP.md A7)")
    p.add_argument("--n_seeds", type=int, default=1,
                   help="repeat the experiment over consecutive seeds")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)")
    return p


def apply_overrides(cfg: Config, args) -> None:
    if args.random_seed is not None:
        cfg.random_seed = args.random_seed
    if args.batch_size is not None:
        cfg.set_path("train.batch_size", args.batch_size)
    if args.max_epochs is not None:
        cfg.set_path("lightning.trainer.max_epochs", args.max_epochs)
    if args.train_pct is not None:
        cfg.set_path("data.frac", args.train_pct)
    if args.randomize_reports:
        cfg.set_path("data.randomize_reports", True)
    if args.randomize_objects_mode:
        cfg.set_path("data.randomize_objects_mode", args.randomize_objects_mode)
    if args.swap_left_right:
        cfg.set_path("data.swap_left_right", True)
    if args.swap_conditions:
        cfg.set_path("data.swap_conditions", True)
    if args.generate_sent:
        cfg.set_path("data.generate_sent", True)
    if args.mask_mode:
        cfg.set_path("data.mask_mode", args.mask_mode)
    if args.mask_prob is not None:
        cfg.set_path("data.mask_prob", args.mask_prob)
    if args.limit_batches is not None:
        cfg.set_path("lightning.trainer.limit_train_batches", args.limit_batches)
        cfg.set_path("lightning.trainer.limit_val_batches", args.limit_batches)
    if args.no_attn_vec:
        cfg.set_path("model.gloria.no_attn_vec", True)
    if args.fused_kernel:
        cfg.set_path("model.gloria.fused_kernel", True)
    if args.loss_chunk is not None:
        cfg.set_path("train.loss_chunk", args.loss_chunk)
    if args.accumulate_grad_batches is not None:
        cfg.set_path("lightning.trainer.accumulate_grad_batches", args.accumulate_grad_batches)
    if args.steps_per_dispatch is not None:
        cfg.set_path("train.steps_per_dispatch", args.steps_per_dispatch)
    for key in ("no_attn_loss_weight", "attention_divergence_loss_weight",
                "attention_entropy_loss_weight", "segmentation_loss_weight"):
        value = getattr(args, key)
        if value is not None:
            cfg.set_path(f"model.gloria.{key}", value)


def refuse_unported(cfg: Config, args) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP.md item for every
    option of ``cfg`` (after the overrides) or ``args`` the port does not
    take yet; none is dropped in silence."""
    def refuse(what: str, item: str) -> None:
        raise NotImplementedError(f"{what} is not ported yet (queued in ROADMAP.md {item})")

    phase = (cfg.phase or "pretrain").lower()
    if phase not in PHASES:
        raise ValueError(f"unknown phase {cfg.phase!r}; choose from {PHASES}")
    if str(cfg.get_path("lightning.trainer.precision")) in ("16", "bf16"):
        # the model and its steps take dtype=torch.bfloat16 (builder.init_gloria);
        # mapping the config's precision onto it is the second half of A1.2
        refuse("lightning.trainer.precision 16 / bf16 (the driver's precision mapping; set 32)",
               "A1.2")
    if cfg.get_path("train.nvis"):
        refuse("train.nvis (the training-time attention plots; set null)", "A6.1")
    for key in ("attention_divergence_loss_weight", "attention_entropy_loss_weight"):
        if cfg.get_path(f"model.gloria.{key}") is not None:
            refuse(f"model.gloria.{key} (the flat-attention ablation losses)", "A1.6")
    if args.fsdp > 1 or args.tp > 1 or args.multihost:
        refuse("--fsdp / --tp above 1 and --multihost (multi-device training)", "A7")
    if int(cfg.get_path("lightning.trainer.accumulate_grad_batches") or 1) > 1:
        refuse("--accumulate_grad_batches above 1", "A1.8")
    if int(cfg.get_path("train.steps_per_dispatch") or 1) > 1:
        refuse("--steps_per_dispatch above 1", "A1.8")
    if cfg.get_path("train.loss_chunk") is not None:
        refuse("--loss_chunk (the port's local loss has one route)", "A1.8")


def localization_callbacks(cfg: Config, dm) -> tuple[list, object]:
    """The pretrain phase's attention callbacks that ``cfg.lightning`` asks
    for, and the train loader when one of them must hold the loader the
    trainer iterates (``WeightInstancesByLocalization`` sets its weights),
    else None."""
    from .training.localization import EvaluateLocalization, WeightInstancesByLocalization

    lightning = cfg.lightning or Config()
    loc_cfg, wil_cfg = lightning.evaluate_localization, lightning.weight_instances_by_localization
    callbacks, train_loader = [], None
    if wil_cfg:
        train_loader = dm.train_dataloader()
        callbacks.append(WeightInstancesByLocalization(
            train_loader, len(train_loader.dataset),
            weight_mode=wil_cfg.weight_mode or "attn_entropy", temp=float(wil_cfg.temp or 0.2)))
    if loc_cfg:
        callbacks.append(EvaluateLocalization(
            cfg, save_dir=Path(cfg.output_dir) / "localization",
            eval_attn_overlay_mode=loc_cfg.eval_attn_overlay_mode or "upsample",
            plot_attn_overlay_mode=loc_cfg.plot_attn_overlay_mode or "upsample",
            log_train_every=int(loc_cfg.log_train_every or 100),
            save_full_data=bool(cfg.data.gold_test) if cfg.data else False))
    return callbacks, train_loader


def main(cfg: Config, args, device=None) -> dict:
    """One experiment: train, validate and test as ``args`` asks, on
    ``device`` (else ``args.device``, else the card)."""
    import torch

    from . import builder
    from .data.data_module import build_data_module
    from .ops import local_sim
    from .training.checkpoints import (CheckpointManager, load_checkpoint, load_checkpoint_meta,
                                       restore_train_state)
    from .training.tasks import LogSegmentationSamples
    from .training.trainer import ProfileTrace, Trainer
    from .utils.device import resolve_device
    from .utils.logging import MetricLogger

    t_main = time.perf_counter()
    timing: dict[str, float] = {}
    refuse_unported(cfg, args)
    phase = (cfg.phase or "pretrain").lower()
    device = resolve_device(device if device is not None else getattr(args, "device", None))
    if device.type == "cuda":
        # precision 32 is f32: no TF32 in cuDNN's convolutions or cuBLAS's products
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.init()
        torch.empty(1, device=device)
    timing["device_init"] = time.perf_counter() - t_main

    t = time.perf_counter()
    dm = build_data_module(cfg, device=device)
    ckpt_cfg = (cfg.lightning.checkpoint_callback if cfg.lightning else None) or Config()
    manager = CheckpointManager(
        Path(cfg.output_dir) / "ckpt",
        monitor=ckpt_cfg.get("monitor", "val_loss"),
        mode=ckpt_cfg.get("mode", "min"),
        save_top_k=int(ckpt_cfg.get("save_top_k", 1)),
        save_last=bool(ckpt_cfg.get("save_last", True)),
        async_save=bool(ckpt_cfg.get("async_save", False)),
    )
    manager.save_tokenizer(dm.tokenizer)
    logger_cfg = cfg.lightning.logger if cfg.lightning else None
    use_wandb = bool(logger_cfg) and "wandb" in str(logger_cfg.logger_type or "").lower()
    logger = MetricLogger(cfg.output_dir, project=logger_cfg.project if logger_cfg else None,
                          experiment=cfg.experiment_name, use_wandb=use_wandb)
    timing["data_module"] = time.perf_counter() - t

    t = time.perf_counter()
    seed = int(cfg.random_seed or 0)
    payload = load_checkpoint(args.ckpt)[0] if args.ckpt else None
    resume = bool(args.resume and payload is not None and "opt_state" in payload)
    callbacks, extractor, task, train_loader = [], None, None, None
    if phase == "pretrain":
        callbacks, train_loader = localization_callbacks(cfg, dm)
        model, state, train_step, eval_step = builder.init_gloria(
            cfg, seed=seed, device=device, return_attn=bool(callbacks))
        if payload is not None:
            restore_train_state(state, payload, resume=resume)
        convnet = model.img_encoder
    else:
        task, state = builder.init_task(
            cfg, pretrained=payload["model"] if payload is not None and not resume else None,
            seed=seed, device=device, resume_from=payload if resume else None)
        convnet, train_step, eval_step = task.model, task.train_step, task.validation_step
        extractor = task.metric_extractor
        if phase == "segmentation":
            callbacks.append(LogSegmentationSamples())
    if device.type == "cuda":
        convnet.to(memory_format=torch.channels_last)
        torch.cuda.synchronize(device)
    timing["model_build"] = time.perf_counter() - t

    if args.profile:
        callbacks.append(ProfileTrace(Path(cfg.output_dir) / "profile", steps=int(args.profile)))
    trainer = Trainer(cfg, train_step, eval_step, logger=logger, checkpoints=manager,
                      callbacks=callbacks, metric_extractor=extractor)
    if args.resume and args.ckpt:
        # continue the same run: epoch numbering, data order, plateau and
        # early-stopping history
        trainer.load_state_dict(load_checkpoint_meta(args.ckpt).get("trainer_state", {}))

    results: dict = {}
    launches_before = (local_sim.launches, local_sim.launches_bwd)
    if args.train:
        t = time.perf_counter()
        if train_loader is None:
            train_loader = dm.train_dataloader()
        state = trainer.fit(state, train_loader, dm.val_dataloader())
        timing["fit"] = time.perf_counter() - t
        results["best_ckpt"] = manager.best()
    if args.val:
        t = time.perf_counter()
        results["val"] = trainer.validate(state, dm.val_dataloader())
        timing["val"] = time.perf_counter() - t
    if args.test:
        t = time.perf_counter()
        results["test"] = trainer.test(state, dm.test_dataloader())
        if phase == "classification":
            task.write_results(cfg, results["test"])
        timing["test"] = time.perf_counter() - t
    logger.close()
    timing["main"] = time.perf_counter() - t_main
    results["run"] = {
        "device": str(device) if device.type != "cuda" else torch.cuda.get_device_name(device),
        "phase": phase,
        "seconds": timing,
        "global_step": trainer.global_step,
        "launches": {"local_sim_fwd": local_sim.launches - launches_before[0],
                     "local_sim_bwd": local_sim.launches_bwd - launches_before[1]},
        "checkpoint_saves": manager.saves,
    }
    return results


def cli(argv: list[str] | None = None) -> int:
    args = get_parser().parse_args(argv)
    base_cfg = load_config(args.config)
    apply_overrides(base_cfg, args)
    base_seed = int(base_cfg.random_seed or 0)

    best_ckpts = {}
    for split_idx in range(max(1, args.n_seeds)):
        cfg = load_config(args.config)
        apply_overrides(cfg, args)
        cfg.random_seed = base_seed + split_idx
        np.random.seed(int(cfg.random_seed))

        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        base = args.output_dir or cfg.base_output_dir or "./output"
        name = f"{cfg.experiment_name or 'experiment'}_{stamp}"
        if args.n_seeds > 1:
            name += f"_seed{cfg.random_seed}"
        cfg.output_dir = os.path.join(base, name)
        os.makedirs(cfg.output_dir, exist_ok=True)
        save_config(cfg, os.path.join(cfg.output_dir, "config.yaml"))

        out = main(cfg, args)
        if out.get("best_ckpt"):
            best_ckpts[f"seed_{cfg.random_seed}"] = out["best_ckpt"]
            # on disk after every seed and before stdout is touched: a caller
            # that held our pipe may be gone, and print() would then raise
            with open(os.path.join(base, "best_ckpts.yaml"), "w") as fh:
                fh.write(dumps_json(best_ckpts) + "\n")
        try:
            print("[run] " + json.dumps(out.pop("run")), flush=True)
            print(out, flush=True)
        except BrokenPipeError:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
