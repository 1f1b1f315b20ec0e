"""Build and load the port's CUDA kernels.

All `csrc/*.cu` sources compile with nvcc (one process per source, run
in parallel) and link into ONE shared library with a plain C interface, `build/trident_tpu_torch/libtrident_kernels.so` under the
repository root, loaded with ctypes. The build runs at first use (never at
import) and is cached: a stamp file beside the library holds a hash of the
sources and flags, and any change rebuilds. A failed build raises with
nvcc's stderr; nothing falls back.

Flags: `-fmad=false` keeps `a*x + b*y + c` as separately rounded IEEE ops,
exactly what PyTorch's eager elementwise ops compute, so each kernel can be
held bit for bit against its plain PyTorch version. Division keeps the
default `-prec-div=true` (an IEEE reciprocal, as `pl.reciprocal(approx=
False)` is on the TPU); `-use_fast_math` is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "trident_tpu_torch"
LIB_NAME = "libtrident_kernels.so"
COMPILE_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-fmad=false",
                 "-gencode", "arch=compute_90a,code=sm_90a")
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")

_lib: Optional[ctypes.CDLL] = None
_kernels: dict = {}      # name → (argtypes, declared entry point)
# C entry point name → launches since the process started (launch's count;
# a captured launch counts once, a graph replay not at all)
LAUNCHES: Counter = Counter()
build_seconds: Optional[float] = None   # wall time of the last build


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_key() -> str:
    """Hash of every kernel source and the flags — the build cache key."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library if the cached one is missing or stale; return
    its path. Each source compiles to an object in its own nvcc process,
    all started together; one more nvcc links them."""
    global build_seconds
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".key")
    key = source_key()
    if lib_path.is_file() and stamp.is_file() and stamp.read_text() == key:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _obj, proc in jobs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
               *[str(obj) for _c, obj, _p in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib_path)
    stamp.write_text(key)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point `name` with its argument types declared. Every entry
    point returns the launch's cudaGetLastError() as an int. Declared once
    per name and remembered: a later call with the same types returns the
    same object, one with other types raises."""
    argtypes = tuple(argtypes)
    known = _kernels.get(name)
    if known is None:
        fn = getattr(load_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        known = _kernels[name] = (argtypes, fn)
    if known[0] != argtypes:
        raise ValueError(f"{name} was declared with argument types "
                         f"{known[0]}, not {argtypes}")
    return known[1]


def check_tensor(name: str, t, dtype, shape: tuple, dev,
                 align: bool = False) -> None:
    """Raise ValueError unless kernel argument `t` is on `dev`, of `dtype`
    and `shape`, contiguous and, with `align`, 16-byte aligned."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not {dev}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte aligned address")


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def launch(name: str, argtypes: Sequence, device, *args) -> None:
    """Launch entry point `name`, whose arguments before the stream are
    `args` of `argtypes`, on `device` (made current for the call) and on
    its current stream; raise if the launch failed, else count it in
    LAUNCHES[name]."""
    fn = kernel(name, (*argtypes, ctypes.c_void_p))
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check_launch(name, err)
    LAUNCHES[name] += 1
