"""The port stands alone: it imports no JAX, nothing of ``gloria_tpu``, no
PyYAML (absent on the card's machine; the port reads configs itself) and no
sklearn (it computes its curves itself); cv2, PIL, pandas and spaCy only inside
the functions that use them; its entry points refuse to pick the CPU on
their own, and ``chip_smoke.py`` fails where there is no card or no checkout
around it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gloria_tpu_torch import api, serving
from gloria_tpu_torch.configs import Config
from gloria_tpu_torch.models.gloria_model import init_gloria

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "gloria_tpu", "yaml", "sklearn")
LAZY = ("cv2", "PIL", "pandas", "spacy")  # imported inside the functions that use them


def _port_files():
    return sorted((ROOT / "gloria_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_static_scan_imports_no_jax_or_gloria_tpu():
    files = _port_files()
    assert len(files) > 10
    offenders = [(str(p.relative_to(ROOT)), m) for p in files for m in _imported_roots(p)
                 if m in FORBIDDEN]
    assert offenders == []


def test_static_scan_imports_cv2_pandas_spacy_only_inside_functions():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        for node in top:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            offenders += [(str(path.relative_to(ROOT)), n) for n in names
                          if n.split(".")[0] in LAZY]
    assert offenders == []


def test_grounding_modules_import_without_pandas_cv2_or_spacy():
    code = ("import sys; sys.modules.update(cv2=None, pandas=None, spacy=None, sklearn=None); "
            "import gloria_tpu_torch.data.mimic, gloria_tpu_torch.data.text_masking, "
            "gloria_tpu_torch.training.localization, gloria_tpu_torch.utils.viz, "
            "gloria_tpu_torch.run; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'gloria_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, gloria_tpu_torch, gloria_tpu_torch.api, gloria_tpu_torch.serving, "
            "gloria_tpu_torch.utils.weights, gloria_tpu_torch.utils.cuda_build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'gloria_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_driver_reads_every_config_with_yaml_blocked():
    code = ("import sys, glob; sys.modules['yaml'] = None; "
            "import gloria_tpu_torch.run, gloria_tpu_torch.builder; "
            "from gloria_tpu_torch.configs import load_config; "
            "cfgs = [load_config(p) for p in sorted(glob.glob('configs/*.yaml'))]; "
            "assert len(cfgs) >= 7 and all(c.model for c in cfgs); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'gloria_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny_cfg():
    return Config({
        "model": {"vision": {"model_name": "resnet_18"},
                  "text": {"embedding_dim": 16, "agg_tokens": True,
                           "bert_config": {"vocab_size": 64, "hidden_size": 16, "num_layers": 1,
                                           "num_heads": 2, "intermediate_size": 32,
                                           "max_position_embeddings": 32}}},
        "transforms": {"norm": "half"},
    })


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    state = init_gloria(cfg, seed=0).state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.GloriaModel(cfg, state)
    ckpt = tmp_path / "m.ckpt"
    torch.save({"state_dict": {f"gloria.{k}": v for k, v in state.items()},
                "hyper_parameters": cfg.to_dict()}, ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_gloria(str(ckpt))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.main(["--ckpt", str(ckpt), "--no-warmup", "--port", "0"])
    gm = api.load_gloria(str(ckpt), device="cpu")  # asking for the CPU works
    assert gm.device.type == "cpu"


def test_load_gloria_refuses_a_checkpoint_directory(tmp_path):
    with pytest.raises(RuntimeError, match="gloria_tpu.utils.torch_export"):
        api.load_gloria(str(tmp_path), device="cpu")


def test_init_keeps_activations_finite():
    cfg = _tiny_cfg()
    gm = api.GloriaModel(cfg, init_gloria(cfg, seed=3).state_dict(), device="cpu")
    imgs = (np.random.RandomState(0).rand(2, 64, 64, 1) * 255).astype(np.uint8)
    img_l, img_g = gm.encode_images(imgs)
    assert img_l.shape == (2, 361, 16) and bool(torch.isfinite(img_l).all())
    assert bool(torch.isfinite(img_g).all())


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
