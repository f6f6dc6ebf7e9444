"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use by `nvcc` into a shared
library with a plain C interface and loaded with `ctypes`.  Libraries go to
`build/kernels/` at the root of the checkout, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# No fast math and no FMA contraction: the kernels must round every float
# operation as the plain PyTorch versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float

# C entry points and their argument types, per source file.
_SIGNATURES = {
    "fused_motion": {
        "swt_fused_motion": [
            _VOID_P, _VOID_P, _INT, _INT, _INT, _INT,
            ctypes.POINTER(_FLOAT), _INT, _FLOAT, _FLOAT, _VOID_P,
        ],
    },
    "rank_compact": {
        "swt_label_rank_fused": [
            _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
            _INT, _INT, _INT, _INT, _VOID_P,
        ],
        "swt_rank_seed_sweep": [
            _VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT, _INT, _INT, _INT, _VOID_P,
        ],
    },
    "ccl_local": {
        "swt_converge_frames": [
            _VOID_P, _VOID_P, _VOID_P, _VOID_P,
            _INT, _INT, _INT, _INT, _FLOAT, _VOID_P,
        ],
    },
    "ccl_sweep": {
        "swt_sweep_chunk": [
            _VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT, _INT, _INT, _INT, _FLOAT, _VOID_P,
        ],
    },
    "ialm_front": {
        "swt_ialm_front": [
            _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
            _INT, _INT, _INT, _INT, _INT, _INT, _FLOAT, _VOID_P,
        ],
        # the same launch without the Gram, for timing K6's parts
        "swt_ialm_front_stream": [
            _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
            _INT, _INT, _INT, _INT, _INT, _INT, _FLOAT, _VOID_P,
        ],
    },
    "track_scan": {
        "swt_track_scan": [
            *[_VOID_P] * 7, _VOID_P, _INT, _INT,        # state in; ROI mask, H, W
            *[_VOID_P] * 5, _INT, _INT,                 # frames; T, K
            _VOID_P, _INT, _INT,                        # pattern table, its rows, n_enum
            *[_FLOAT] * 8,                              # cost constants
            *[_VOID_P] * 14, _INT, _VOID_P,             # state out, events; cap; stream
        ],
    },
}

KERNEL_SOURCES = tuple(sorted(_SIGNATURES))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from swiftwatcher_tpu_torch/csrc at first use"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, with argtypes set."""
    lib_path = _library_path(name)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _INT
    return lib


def build_all() -> float:
    """Build and load every kernel, one nvcc per source, all started
    together; returns the seconds it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        for future in [pool.submit(load_library, name) for name in KERNEL_SOURCES]:
            future.result()
    return time.perf_counter() - t0


def check_operand(what: str, t: torch.Tensor, dtype: torch.dtype, like=None) -> None:
    """Raise unless `t` is a contiguous (N, H, W) CUDA tensor of `dtype`
    (with the shape and device of `like`, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.dtype != dtype or t.dim() != 3:
        raise ValueError(f"{what}: want (N, H, W) {dtype}, got {tuple(t.shape)} {t.dtype}")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{what}: operands differ in shape or device")
    if not t.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C launcher `entry` of `csrc/<name>.cu` with `args` and the
    current stream of `device`; raise if it returns a nonzero cudaError_t."""
    lib = load_library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed (cudaError_t {rc})")
