"""Ensemble sharding: the Monte-Carlo realisations spread over
``torch.distributed`` ranks.

The reference is one process on one card; its only cross-realisation
communication is the accept-masked ensemble mean.  So the realisation axis
splits cleanly: every rank holds the same points ``Z`` and the same full
draw ``beta`` (made from the same seed), keeps its own block of rows
(``torch.tensor_split`` of ``range(R)``: uneven blocks are allowed, and
the masked sum stays exact, so nothing is padded), runs lift, evolve and
restriction on them with its kernels, and adds its masked position sums
and accept counts into ONE all-reduce.  Every rank then divides the same
totals and returns the same ``f``: the results differ from the unsharded
map only by the reassociated ensemble sum.  The JAX package's two routes
are both this one function: GSPMD (the unsharded draw, split) and
``shard_map`` (per-device draws: pass a draw whose row blocks are the
per-rank draws).

Every host decision of the solvers (convergence, damping, the staged
rescue, an exact Jacobian's outcome check) is taken on all-reduced values,
so the ranks never part ways around a collective.  The process group has
a timeout, and :func:`run_ranks` brings the whole run down when one rank
raises.

Backends: NCCL where every rank has its own card, gloo on the CPU and for
ranks that share a card (NCCL refuses two ranks on one GPU); gloo moves a
CUDA tensor's sums through the host.  The choice is printed.
"""

from __future__ import annotations

import datetime
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from ..config import MapParams, ModelConfig, NewtonConfig
from ..model.emap import event_driven_map, make_residual_fn
from ..solvers.newton import NewtonResult, newton_solve
from ..utils.profiling import spanned

# seconds a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0


def choose_backend(device_type: str, world_size: int) -> str:
    """The collective backend for ``world_size`` ranks on ``device_type``
    (``"cpu"`` or ``"cuda"``): NCCL when every rank has a card of its
    own, else gloo (NCCL refuses two ranks on one card)."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda'; got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a sharded run on 'cuda' needs a CUDA card")
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def _init_ranks(rank: int, world_size: int, init_method: str,
                device_type: str, timeout_s: float) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` at the
    ``file://`` store ``init_method`` and return this rank's device:
    ``cuda:rank`` modulo the cards (made the current device), or the CPU.
    Rank 0 prints the backend."""
    backend = choose_backend(device_type, world_size)
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    if rank == 0:
        print(f"sharding: {world_size} rank(s) on {backend} "
              f"({device_type})", file=sys.stderr, flush=True)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


class ShardGroup:
    """This rank's share of an ensemble of ``n_real`` realisations: the
    counterpart of the JAX package's ``make_mesh({"real": n})``.

    Attributes: ``rank``, ``world_size`` and ``backend`` of the default
    process group, ``n_real`` and this rank's row block ``[lo, hi)`` of
    ``count`` rows, the ``rank``-th block of
    ``torch.tensor_split(range(n_real), world_size)``.  ``reduces`` counts
    the all-reduces, each a ``parallel.all_reduce`` span
    (:mod:`..utils.profiling`).
    """

    def __init__(self, n_real: int):
        if not dist.is_initialized():
            raise RuntimeError("ShardGroup needs an initialised process "
                               "group (run_ranks)")
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self.backend = dist.get_backend()
        if self.world_size > n_real:
            raise ValueError(f"{self.world_size} ranks for n_real={n_real} "
                             "realisations: a rank would hold none")
        self.n_real = n_real
        block = torch.tensor_split(torch.arange(n_real),
                                   self.world_size)[self.rank]
        self.lo, self.hi = int(block[0]), int(block[-1]) + 1
        self.count = self.hi - self.lo
        self.reduces = 0

    def localize(self, cfg: ModelConfig, *xs: Optional[torch.Tensor],
                 P: int = 1) -> tuple:
        """``(cfg, *rows)``: ``cfg`` with ``n_real`` this rank's row count,
        and this rank's :meth:`rows` of each of ``xs`` (None stays None)."""
        if cfg.n_real != self.n_real:
            raise ValueError(f"the group splits n_real={self.n_real}; the "
                             f"config has {cfg.n_real}")
        return (cfg.with_(n_real=self.count),
                *(None if x is None else self.rows(x, P) for x in xs))

    def rows(self, x: torch.Tensor, P: int = 1) -> torch.Tensor:
        """This rank's rows of an ``(n_real, N)`` draw or noise, or of a
        ``(P * n_real, N)`` draw of points with their own parameters
        (rows ``p * n_real + r``: the block of every point)."""
        R = self.n_real
        if x.ndim == 2 and x.shape[0] == R:
            return x[self.lo:self.hi]
        if x.ndim == 2 and x.shape[0] == P * R:
            return x.view(P, R, -1)[:, self.lo:self.hi].reshape(
                P * self.count, -1)
        raise ValueError(f"expected ({R}, N) or ({P * R}, N) rows; got "
                         f"{tuple(x.shape)}")

    @spanned("parallel.all_reduce")
    def all_reduce(self, *tensors: torch.Tensor) -> tuple:
        """The sums over the ranks of ``tensors`` (one dtype, one device),
        in ONE all-reduce of their concatenation."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if flat.is_cuda and self.backend == "gloo":
            host = flat.cpu()
            dist.all_reduce(host)
            flat = host.to(flat.device)
        else:
            dist.all_reduce(flat)
        self.reduces += 1
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)


def event_driven_map_sharded(cfg: ModelConfig, params: MapParams,
                             beta: torch.Tensor, Z: torch.Tensor,
                             group: ShardGroup, **kw) -> torch.Tensor:
    """:func:`..model.emap.event_driven_map` with the ensemble sharded
    over ``group``: ``beta`` is the full draw; every rank returns the
    same ``f``."""
    return event_driven_map(cfg, params, beta, Z, group=group, **kw)


def make_sharded_residual_fn(cfg: ModelConfig, params: MapParams,
                             beta: torch.Tensor, group: ShardGroup, *,
                             evolve_backend: str = "auto"):
    """Residual oracle ``F: Z -> f`` (with its exact Jacobian) over the
    full draw ``beta``, each evaluation sharded over ``group``."""
    return make_residual_fn(cfg, params, 0, device=beta.device, beta=beta,
                            evolve_backend=evolve_backend, group=group)


def sharded_newton_solve(cfg: ModelConfig, params: MapParams,
                         beta: torch.Tensor, Z0: torch.Tensor,
                         newton_cfg: NewtonConfig, group: ShardGroup, *,
                         evolve_backend: str = "auto") -> NewtonResult:
    """Newton with the ensemble sharded over ``group``: every rank runs
    the same loop on the replicated ``Z`` and the same reduced ``f``."""
    F = make_sharded_residual_fn(cfg, params, beta, group,
                                 evolve_backend=evolve_backend)
    return newton_solve(F, Z0.to(dtype=cfg.torch_dtype, device=beta.device),
                        newton_cfg)


def _rank_main(rank: int, fn: Callable, args: tuple, world_size: int,
               init_method: str, device_type: str, timeout_s: float,
               out_dir: str, threads: int) -> None:
    """One rank of :func:`run_ranks`: join the group, run ``fn(*args)``,
    save its result for the parent; on an error, record when it came (the
    ranks that wait for this one fail after it, in a collective)."""
    torch.set_num_threads(threads)
    _init_ranks(rank, world_size, init_method, device_type, timeout_s)
    try:
        out = fn(*args)
    except BaseException:
        Path(out_dir, f"rank{rank}.error").write_text(
            f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args,
              device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
              workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks started here with the
    ``spawn`` method (CUDA cannot be forked), each in the default process
    group, and return the list of their results (rank order; saved with
    ``torch.save``, loaded onto the CPU).

    ``fn`` and ``args`` must pickle (a module-level function); ``fn``
    makes its :class:`ShardGroup`.  On ``"cuda"`` the kernel library is
    built here first, so the ranks only load it.  The ranks meet at a
    ``file://`` store in a fresh temporary directory
    (inside ``workdir`` if given) and share this process's CPU threads.
    When a rank raises, the others are stopped and a ``RuntimeError``
    with the traceback of the rank that failed first is raised here; a
    rank that dies without one raises ``torch.multiprocessing``'s
    ``ProcessExitedException``.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be positive; got {world_size}")
    device_type = torch.device(device).type
    choose_backend(device_type, world_size)    # refuse a bad setup here
    if device_type == "cuda":
        from .._build import load_library
        load_library()
    with tempfile.TemporaryDirectory(prefix="atorch_ranks_",
                                     dir=workdir) as tmp:
        init_method = Path(tmp, "store").as_uri()
        try:
            torch.multiprocessing.spawn(
                _rank_main, args=(fn, args, world_size, init_method,
                                  device_type, timeout_s, tmp,
                                  max(1, torch.get_num_threads()
                                      // world_size)),
                nprocs=world_size, join=True)
        except ProcessException as err:
            errors = [(*path.read_text().split("\n", 1), path.stem)
                      for path in Path(tmp).glob("rank*.error")]
            if not errors:
                raise
            _, trace, name = min(errors, key=lambda e: float(e[0]))
            raise RuntimeError(f"{name} failed first:\n{trace}") from err
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False)
                for r in range(world_size)]
