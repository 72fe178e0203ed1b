"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``gloria_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use with ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
The library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
an unchanged one is loaded as it is.  Nothing
here runs at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of this process's nvcc run; 0.0 when loaded from a previous build
    log: str        # nvcc's output, ptxas's register / shared-memory / spill lines included


_LOADED: dict[str, Built] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's CUDA "
            "kernels are built from gloria_tpu_torch/csrc with the CUDA toolkit")
    return found


def build(names: list[str]) -> dict[str, Built]:
    """Compile (one nvcc process per source, all started together) and load
    ``csrc/<name>.cu`` for each name; raises with nvcc's output on failure."""
    with _LOCK:
        pending = {}
        for name in names:
            if name in _LOADED or name in pending:
                continue
            src = CSRC / f"{name}.cu"
            headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
            digest = hashlib.sha256(src.read_bytes() + headers
                                    + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            so = BUILD_DIR / f"{name}-{digest}.so"
            if so.exists():
                log = so.with_suffix(".log")
                pending[name] = (so, None, None, log.read_text() if log.exists() else "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            pending[name] = (so, tmp, proc, time.perf_counter())
        for name, (so, tmp, proc, extra) in pending.items():
            if proc is None:
                _LOADED[name] = Built(ctypes.CDLL(str(so)), so, 0.0, extra)
                continue
            log, _ = proc.communicate(timeout=900)
            seconds = time.perf_counter() - extra
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {CSRC / (name + '.cu')}:\n{log}")
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a concurrent builder sees a whole library or none
            _LOADED[name] = Built(ctypes.CDLL(str(so)), so, seconds, log)
        return {name: _LOADED[name] for name in names}
