"""ctypes bindings for the native host-ingest library (``native/ingest.cpp``).

The port's own copy of ``gloria_tpu.data.native``.  One call per batch:
fused letterbox (area) + pad + optional crop and horizontal flip +
channel-replicate + normalize over a C++ thread pool, writing the final
NHWC float32 buffer; the ``*_u8_batch`` variants write raw single-channel
uint8 pixels for batches normalized on the device.

The library is compiled at first use from ``gloria_tpu_torch/native/ingest.cpp``
with ``g++`` into ``build/native/`` at the root of the checkout (listed in
``.gitignore``).  Its file name carries a hash of the source, the flags and
the host CPU (``-march=native``), and it is written to a temporary file renamed into place, so concurrent
builders (test workers) each see a whole library or none.  There is no
fallback: when the library cannot be built or loaded, every call raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread", "-std=c++17")
ABI_VERSION = 3

_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
_F32P = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = {
    "letterbox_normalize_batch": [
        ctypes.POINTER(_U8P), _INTP, _INTP, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, _F32P],
    "letterbox_crop_normalize_batch": [
        ctypes.POINTER(_U8P), _INTP, _INTP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _INTP,
        _INTP, _INTP, ctypes.c_float, ctypes.c_float, ctypes.c_int, _F32P],
    "letterbox_u8_batch": [
        ctypes.POINTER(_U8P), _INTP, _INTP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P],
    "letterbox_crop_u8_batch": [
        ctypes.POINTER(_U8P), _INTP, _INTP, ctypes.c_int, ctypes.c_int, ctypes.c_int, _INTP,
        _INTP, _INTP, ctypes.c_int, _U8P],
}


@dataclasses.dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of this process's g++ run; 0.0 when loaded from a previous build


_BUILT: Built | None = None
_LOCK = threading.Lock()


def _cpu_signature() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    them, so a library built on another machine (a copied checkout) is not
    taken for this one's."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def library_path() -> Path:
    """Where this source, these flags and this CPU's build lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _cpu_signature()).hexdigest()[:16]
    return BUILD_DIR / f"libgloria_ingest-{digest}.so"


def load() -> Built:
    """The loaded library, compiled first when no build of this source and
    these flags exists; raises with the compiler's output when it cannot be
    built or loaded."""
    global _BUILT
    with _LOCK:
        if _BUILT is not None:
            return _BUILT
        so, seconds = library_path(), 0.0
        if not so.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("native ingest: no C++ compiler (g++ or $CXX) to build "
                                   f"{SOURCE}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                      capture_output=True, text=True, timeout=300)
            except OSError as exc:
                raise RuntimeError(f"native ingest: cannot run {cxx}: {exc}") from exc
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"native ingest: {cxx} failed on {SOURCE}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent builder sees a whole library or none
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:
            raise RuntimeError(f"native ingest: cannot load {so}: {exc}") from exc
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        lib.ingest_abi_version.argtypes, lib.ingest_abi_version.restype = [], ctypes.c_int
        if lib.ingest_abi_version() != ABI_VERSION:
            raise RuntimeError(f"native ingest: {so} has ABI {lib.ingest_abi_version()}, "
                               f"expected {ABI_VERSION}")
        _BUILT = Built(lib, so, seconds)
        return _BUILT


def _u8_ptrs(images: list[np.ndarray]):
    """Grayscale uint8 C-contiguous copies (the first channel of a color
    image), their pointers, heights and widths.  The caller keeps the
    returned list alive while the library reads it."""
    n = len(images)
    images = [np.ascontiguousarray(im if im.ndim == 2 else im[..., 0], np.uint8)
              for im in images]
    ptrs = (_U8P * n)(*[im.ctypes.data_as(_U8P) for im in images])
    heights = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    widths = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    return images, ptrs, heights, widths


def _ints(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)


def _check_crop(n: int, size: int, crop_size: int, crop_tops, crop_lefts, flips) -> None:
    if not 0 < crop_size <= size:
        raise ValueError(f"crop_size {crop_size} must be in (0, {size}]")
    for name, v in (("crop_tops", crop_tops), ("crop_lefts", crop_lefts), ("flips", flips)):
        if len(v) != n:
            raise ValueError(f"{name} has {len(v)} entries for {n} images")
    offsets = np.concatenate([np.asarray(crop_tops), np.asarray(crop_lefts)])
    if n and (offsets.min() < 0 or offsets.max() > size - crop_size):
        raise ValueError(f"crop offsets must be in [0, {size - crop_size}]")


def letterbox_normalize_batch(
    images: list[np.ndarray], size: int, mean: float = 0.5, std: float = 0.5,
    num_threads: int = 0,
) -> np.ndarray:
    """Grayscale uint8 images (varying sizes) → [N, size, size, 3] float32,
    letterboxed and normalized ((x/255 - mean) / std)."""
    lib = load().lib
    images, ptrs, heights, widths = _u8_ptrs(images)
    n = len(images)
    out = np.empty((n, size, size, 3), np.float32)
    lib.letterbox_normalize_batch(ptrs, heights, widths, n, size, mean, std,
                                  num_threads or (os.cpu_count() or 4),
                                  out.ctypes.data_as(_F32P))
    return out


def letterbox_crop_normalize_batch(
    images: list[np.ndarray], size: int, crop_size: int,
    crop_tops: np.ndarray, crop_lefts: np.ndarray, flips: np.ndarray,
    mean: float = 0.5, std: float = 0.5, num_threads: int = 0,
) -> np.ndarray:
    """Training path: letterbox to ``size``, crop ``crop_size`` at the given
    offsets, optional horizontal flip, normalize — one fused pass."""
    lib = load().lib
    images, ptrs, heights, widths = _u8_ptrs(images)
    n = len(images)
    _check_crop(n, size, crop_size, crop_tops, crop_lefts, flips)
    out = np.empty((n, crop_size, crop_size, 3), np.float32)
    lib.letterbox_crop_normalize_batch(ptrs, heights, widths, n, size, crop_size,
                                       _ints(crop_tops), _ints(crop_lefts), _ints(flips),
                                       mean, std, num_threads or (os.cpu_count() or 4),
                                       out.ctypes.data_as(_F32P))
    return out


def letterbox_u8_batch(images: list[np.ndarray], size: int,
                       num_threads: int = 0) -> np.ndarray:
    """Grayscale uint8 images → [N, size, size, 1] uint8, letterboxed, raw
    pixels (GLoRIA's uint8 input branch broadcasts C=1→3 and normalizes on
    the device)."""
    lib = load().lib
    images, ptrs, heights, widths = _u8_ptrs(images)
    n = len(images)
    out = np.empty((n, size, size), np.uint8)
    lib.letterbox_u8_batch(ptrs, heights, widths, n, size,
                           num_threads or (os.cpu_count() or 4), out.ctypes.data_as(_U8P))
    return out[..., None]


def letterbox_crop_u8_batch(
    images: list[np.ndarray], size: int, crop_size: int,
    crop_tops: np.ndarray, crop_lefts: np.ndarray, flips: np.ndarray,
    num_threads: int = 0,
) -> np.ndarray:
    """Training path, uint8 out: letterbox to ``size``, crop ``crop_size`` at
    the given offsets, optional horizontal flip — raw pixels, [N, crop, crop, 1]."""
    lib = load().lib
    images, ptrs, heights, widths = _u8_ptrs(images)
    n = len(images)
    _check_crop(n, size, crop_size, crop_tops, crop_lefts, flips)
    out = np.empty((n, crop_size, crop_size), np.uint8)
    lib.letterbox_crop_u8_batch(ptrs, heights, widths, n, size, crop_size,
                                _ints(crop_tops), _ints(crop_lefts), _ints(flips),
                                num_threads or (os.cpu_count() or 4), out.ctypes.data_as(_U8P))
    return out[..., None]
