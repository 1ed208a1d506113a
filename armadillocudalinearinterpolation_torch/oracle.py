"""ctypes binding of the native fp64 oracle (``native/edmap_oracle.cpp``).

The oracle is an independent C++ implementation of the map and of its
damped Newton solve, in plain double: the ``sigma = 0`` anchor that the
port's f64 map is held to (the JAX package's ``oracle.py``).  The source
in ``native/`` is only read: ``g++`` builds it at first use, with
``native/Makefile``'s flags, into ``build/oracle/`` at the root of the
checkout, keyed by a hash of the source, the flags, the compiler and the
host (the flags hold ``-march=native``).  A missing ``g++`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .config import MapParams, ModelConfig

SOURCE = Path(__file__).resolve().parent.parent / "native" / "edmap_oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "oracle"
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra"]
LD_FLAGS = ["-shared", "-lpthread"]


class _CParams(ctypes.Structure):
    """``Params`` of ``edmap_oracle.cpp``."""
    _fields_ = [
        ("n_neurons", ctypes.c_int),
        ("n_real", ctypes.c_int),
        ("n_spikes", ctypes.c_int),
        ("n_threads", ctypes.c_int),
        ("vth", ctypes.c_double),
        ("vr", ctypes.c_double),
        ("a1", ctypes.c_double),
        ("a2", ctypes.c_double),
        ("b1", ctypes.c_double),
        ("b2", ctypes.c_double),
        ("drive", ctypes.c_double),
        ("half_width", ctypes.c_double),
        ("t_horizon", ctypes.c_double),
        ("root_tol", ctypes.c_double),
        ("counter_max", ctypes.c_int),
        ("beta_mean", ctypes.c_double),
        ("beta_sigma", ctypes.c_double),
        ("seed", ctypes.c_uint64),
    ]


_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_COMPUTE_F_ARGS = [ctypes.POINTER(_CParams), _F64, _F64, ctypes.c_void_p,
                   ctypes.c_void_p]
_NEWTON_ARGS = [ctypes.POINTER(_CParams), _F64, ctypes.c_double,
                ctypes.c_int, ctypes.c_double, ctypes.c_double, _F64, _F64,
                ctypes.POINTER(ctypes.c_int), _F64]


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native fp64 oracle "
                           f"({SOURCE.name}) cannot be built")
    return cxx


def library_path(cxx: str) -> Path:
    """The built library's path: a hash of the source, the flags, the
    compiler's version and the host."""
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(version.encode())
    h.update(" ".join(platform.uname()).encode())
    return BUILD_DIR / f"libedmap_oracle_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the oracle unless its library exists (a per-process
    temporary, then ``os.replace``: concurrent builds are safe)."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                               *LD_FLAGS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use only) and load the oracle; set its signatures."""
    lib = ctypes.CDLL(str(build()))
    lib.edmap_compute_f.restype = None
    lib.edmap_compute_f.argtypes = _COMPUTE_F_ARGS
    lib.edmap_newton_solve.restype = ctypes.c_int
    lib.edmap_newton_solve.argtypes = _NEWTON_ARGS
    return lib


def c_params(cfg: ModelConfig, params: MapParams, seed: int = 0,
             n_threads: int = 0) -> _CParams:
    """The oracle's parameter block (``n_threads`` 0: every core)."""
    return _CParams(
        n_neurons=cfg.n_neurons, n_real=cfg.n_real, n_spikes=cfg.n_spikes,
        n_threads=n_threads, vth=cfg.vth, vr=cfg.vr, a1=cfg.a1, a2=cfg.a2,
        b1=cfg.b1, b2=cfg.b2, drive=cfg.drive, half_width=cfg.half_width,
        t_horizon=cfg.t_horizon, root_tol=cfg.root_tol,
        counter_max=cfg.counter_max, beta_mean=float(params.beta),
        beta_sigma=float(params.sigma), seed=seed)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float64)


def compute_f(cfg: ModelConfig, params: MapParams, Z, *, seed: int = 0,
              n_threads: int = 0, with_diagnostics: bool = False):
    """The oracle's fp64 residual ``F(Z)`` as a float64 CPU tensor; with
    ``with_diagnostics`` also the ``(R, M)`` restricted positions and the
    ``(R,)`` bool accept flags.  Its heterogeneity (``sigma > 0``) comes
    from its own seeded generator (per realisation, so independent of
    ``n_threads``), not from the port's draw."""
    lib = load()
    p = c_params(cfg, params, seed, n_threads)
    f = np.empty(cfg.n_spikes, np.float64)
    pos = np.empty((cfg.n_real, cfg.n_spikes), np.float64)
    acc = np.empty(cfg.n_real, np.int32)
    lib.edmap_compute_f(ctypes.byref(p), _host(Z), f,
                        pos.ctypes.data_as(ctypes.c_void_p),
                        acc.ctypes.data_as(ctypes.c_void_p))
    if not with_diagnostics:
        return torch.from_numpy(f)
    return (torch.from_numpy(f), torch.from_numpy(pos),
            torch.from_numpy(acc.astype(bool)))


def newton_solve(cfg: ModelConfig, params: MapParams, z0, *,
                 tol: float = 1e-10, max_iterations: int = 15,
                 fd_eps: float = 1e-7, damping: float = 1.0, seed: int = 0,
                 n_threads: int = 0) -> dict:
    """The oracle's damped Newton solve with forward FD: a dict with
    ``solution``, ``iterations``, ``converged``, ``residual_history``
    (NaN-padded to ``max_iterations + 1``) and ``jacobian``, the arrays as
    float64 CPU tensors."""
    lib = load()
    p = c_params(cfg, params, seed, n_threads)
    n = cfg.n_spikes
    z_out = np.empty(n, np.float64)
    hist = np.empty(max_iterations + 1, np.float64)
    jac = np.empty((n, n), np.float64)
    conv = ctypes.c_int(0)
    iters = lib.edmap_newton_solve(ctypes.byref(p), _host(z0), tol,
                                   max_iterations, fd_eps, damping, z_out,
                                   hist, ctypes.byref(conv), jac)
    return {"solution": torch.from_numpy(z_out), "iterations": int(iters),
            "converged": bool(conv.value),
            "residual_history": torch.from_numpy(hist),
            "jacobian": torch.from_numpy(jac)}
