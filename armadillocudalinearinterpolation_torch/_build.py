"""Build the CUDA kernels at first use and load them with ``ctypes``.

The sources in ``csrc/*.cu`` carry a plain ``extern "C"`` interface and
include no PyTorch headers (only the shared device code of
``csrc/*.cuh``), so ``nvcc`` compiles each in seconds; the sources compile
in parallel, one ``nvcc`` each, and one more call links them.  The library
lands in ``build/kernels/libatorch_kernels_<hash>.so`` at the root of the
checkout, keyed by a hash of the sources, the headers and the flags,
so an edited source rebuilds and an unchanged one loads the existing
library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# argument types of every exported function
_SIGNATURES = {
    "atorch_evolve_f32": [_P] * 14 + [_I] * 10 + [_D] * 10 + [_P],
    "atorch_evolve_f64": [_P] * 14 + [_I] * 10 + [_D] * 10 + [_P],
    "atorch_replay_f32": [_P] * 13 + [_I] * 10 + [_D] * 5 + [_P],
    "atorch_replay_f64": [_P] * 13 + [_I] * 10 + [_D] * 5 + [_P],
    "atorch_replay_tangent_f32": [_P] * 20 + [_I] * 12 + [_D] * 5 + [_P],
    "atorch_replay_tangent_f64": [_P] * 20 + [_I] * 12 + [_D] * 5 + [_P],
    "atorch_replay_tangent_smem_bytes": [_I] * 5,
    "atorch_replay_tangent_clusters": [_I] * 8 + [_P],
    "atorch_lift_f32": [_P] * 4 + [_I] * 4 + [_D] * 8 + [_P],
    "atorch_lift_f64": [_P] * 4 + [_I] * 4 + [_D] * 8 + [_P],
    "atorch_lift_tangent_f64": [_P] * 8 + [_I] * 5 + [_D] * 8 + [_P],
    "atorch_bilinear_gather": [_P] * 3 + [_I] * 7 + [_P],
    "atorch_bilinear_binning": [_P] * 5 + [_I] * 8 + [_P],
    "atorch_bilinear_binned": [_P] * 5 + [_I] * 10 + [_P],
    "atorch_bilinear_f64": [_P] * 3 + [_I] * 4 + [_P],
    "atorch_lerp1d": [_P] * 3 + [_L, _I] + [_D] * 2 + [_P],
    "atorch_lerp1d_sorted": [_P] * 4 + [_L, _I, _L, _I] + [_D] * 2 + [_P],
    "atorch_interp1d": [_P] * 5 + [_L, _L] + [_I] * 4 + [_D] * 4 + [_I, _P],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libatorch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, logs) -> None:
    """Start the commands together, each writing to its log, and wait for
    all of them; raise with the output of the first that failed."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    codes = [proc.wait() for proc in procs]
    for cmd, code, log in zip(cmds, codes, logs):
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                               f"{log.read_text()}")


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{out.stem}.{os.getpid()}.{src.stem}.o"
            for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    logs = [obj.with_suffix(".log") for obj in objs] + [tmp.with_suffix(".log")]
    try:
        _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources, objs)], logs[:-1])
        _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]], logs[-1:])
        os.replace(tmp, out)
    finally:
        for f in [tmp, *objs, *logs]:
            f.unlink(missing_ok=True)
    return out


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernels; set every signature."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.atorch_error_string.argtypes = [ctypes.c_int]
        lib.atorch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def entry(name: str):
    """The library's C function ``name``, bound once (the library is
    built and loaded at the first call)."""
    return getattr(load_library(), name)


def launch(fn, what: str, device: int, *args) -> None:
    """Call the C function ``fn`` with ``args`` and the current stream of
    CUDA device ``device``, on that device; raise if it returns a CUDA
    error.  The stream handle comes as a raw int (0.2 us, where
    ``torch.cuda.current_stream().cuda_stream`` takes 8 us;
    ``tools/host_overhead.py``)."""
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch._C._cuda_getDevice():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, stream)
    if code:
        check(load_library(), code, what)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = lib.atorch_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
