"""Build and load the port's hand-written CUDA kernels and host decoders.

Each `csrc/<name>.cu` is compiled at first use by `nvcc` into a shared
library with a plain C interface and loaded with `ctypes`.  Libraries go to
`build/kernels/` at the root of the checkout, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
reused.  A library built with preprocessor defines (`load_library(name,
defines)`, which only tools ask for) is a library of its own.  The host
decoders (`native/<name>.cpp` at the root of the checkout, the libjpeg
frame pump and the libav reader) and the wire codec's encoders
(`csrc/wire_encode.cpp`, the port's own) are built the same way by g++
into `build/native/`; their hash also covers this host's CPU, since they
are built for it (`-march=native`).  Each library is built once per process,
under a lock, so threads that need it first together do not build it
twice.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import torch

from .utils.metrics import trace_range

CSRC = Path(__file__).resolve().parent / "csrc"
ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "build" / "kernels"
NATIVE_SRC = ROOT / "native"
NATIVE_BUILD_DIR = ROOT / "build" / "native"

# No fast math and no FMA contraction: the kernels must round every float
# operation as the plain PyTorch versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
# The JAX package's flags for the same host sources (its io/native.py).
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

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
    "ialm_trip": {
        "swt_ialm_trip_front": [*[_VOID_P] * 8, *[_INT] * 6, _FLOAT, _VOID_P],
        "swt_ialm_trip_back": [*[_VOID_P] * 11, *[_INT] * 6, _FLOAT, _VOID_P],
    },
    "refined_eigh": {
        "swt_refined_eigh": [*[_VOID_P] * 4, _INT, _INT, _INT, _FLOAT, _INT, _VOID_P],
    },
    "track_scan": {
        "swt_track_scan": [
            *[_VOID_P] * 7, _VOID_P, _INT, _INT,        # state in; ROI mask, H, W
            *[_VOID_P] * 5, _INT, _INT,                 # frames; T, K
            _VOID_P, _INT, _INT,                        # pattern table, its rows, n_enum
            *[_FLOAT] * 8,                              # cost constants
            _VOID_P, _INT,                              # records; prologue only
            *[_VOID_P] * 14, _INT, _VOID_P,             # state out, events; cap; stats
            _VOID_P, _VOID_P,                           # kernels launched (host int); stream
        ],
    },
    # K7's barrier-round micro-kernel (chip_smoke.py phase 19), no part of the port
    "k7_latency": {
        "swt_k7_latency": [_INT, _INT, _INT, _VOID_P, _VOID_P],
    },
    # T1's latency micro-kernels (chip_smoke.py phase 11), no part of the port
    "t1_latency": {
        "swt_t1_latency": [_INT, _INT, _INT, _VOID_P, _VOID_P],
    },
}

# The sources of the port's kernels (built by build_all), and the ones that
# only measure them.
TOOL_SOURCES = ("k7_latency", "t1_latency")
KERNEL_SOURCES = tuple(sorted(n for n in _SIGNATURES if n not in TOOL_SOURCES))


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


def _nvcc_flags(defines: Sequence[str]) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _library_path(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_nvcc_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


_locks_guard = threading.Lock()
_locks: dict = {}
_loaded: dict = {}


def _once(key, make):
    """make() the first time `key` is asked for, under a lock of its own;
    later calls return the same result (None included)."""
    if key in _loaded:
        return _loaded[key]
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key not in _loaded:
            _loaded[key] = make()
        return _loaded[key]


def _compile(cmd_head: Sequence[str], cmd_tail: Sequence[str], lib_path: Path, what: str) -> None:
    """Run `cmd_head -o <tmp> cmd_tail` and move the library into place:
    another process never loads a half-written file."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd_head, "-o", tmp, *cmd_tail], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_kernel_library(name: str, defines: Sequence[str]) -> ctypes.CDLL:
    lib_path = _library_path(name, defines)
    if not lib_path.exists():
        _compile([_nvcc(), *_nvcc_flags(defines)], [str(CSRC / f"{name}.cu")], lib_path,
                 f"nvcc for {name}.cu")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _INT
    return lib


def load_library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, with argtypes set;
    `defines` are passed to nvcc as -D flags."""
    defines = tuple(defines)
    return _once(("cuda", name, defines), lambda: _load_kernel_library(name, defines))


def _host_cpu() -> bytes:
    """This host's CPU model and flags: what `-march=native` builds for."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(sorted(set(keep))).encode()


def native_source(name: str) -> Path:
    """The host source `name`: the port's `csrc/<name>.cpp` where there is
    one, else `native/<name>.cpp` at the root of the checkout."""
    own = CSRC / f"{name}.cpp"
    return own if own.exists() else NATIVE_SRC / f"{name}.cpp"


def native_library_path(name: str, libs: Sequence[str]) -> Path:
    """Where the host source `name` built for this host with `libs` goes."""
    h = hashlib.sha256()
    h.update(native_source(name).read_bytes())
    h.update(" ".join([*GXX_FLAGS, *libs]).encode())
    h.update(_host_cpu())
    return NATIVE_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _load_native(name: str, libs: Sequence[str], bind) -> Optional[ctypes.CDLL]:
    src = native_source(name)
    gxx = shutil.which("g++")
    if not src.exists() or gxx is None:
        return None
    lib_path = native_library_path(name, libs)
    if not lib_path.exists():
        try:
            _compile([gxx, *GXX_FLAGS], [str(src), *libs], lib_path, f"g++ for {name}.cpp")
        except RuntimeError:
            return None  # a library it links (libjpeg, libav) is missing here
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None  # the shared libraries it links are not installed here
    bind(lib)
    return lib


def load_native(name: str, libs: Sequence[str], bind) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the host library of `native_source(name)`,
    linked with `libs`, and call bind(lib) once to set its argtypes; None
    when g++ or a linked library is missing (the caller then takes the cv2
    or numpy path, as the JAX package does)."""
    return _once(("native", name), lambda: _load_native(name, tuple(libs), bind))


def build_all(names: Sequence[str] = KERNEL_SOURCES) -> float:
    """Build and load the sources `names` (default: every kernel of the
    port), one nvcc per source, all started together; returns the seconds
    it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for future in [pool.submit(load_library, name) for name in names]:
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


def launch(name: str, entry: str, device: torch.device, *args,
           defines: Sequence[str] = ()) -> None:
    """Call C launcher `entry` of `csrc/<name>.cu` (built with `defines`)
    with `args` and the current stream of `device`; raise if it returns a
    nonzero cudaError_t.  While a profiler runs, its trace shows the call
    as a range named `entry`."""
    lib = load_library(name, defines)
    with trace_range(entry), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed (cudaError_t {rc})")
