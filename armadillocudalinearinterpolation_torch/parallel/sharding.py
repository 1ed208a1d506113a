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
a timeout, and a rank that raises brings the whole call down.

The ranks live in a :class:`RankPool`: the calling process is rank 0, the
others are spawned once and run call after call in ONE process group
(``cli.driver.main(..., pool=...)`` runs sweeps on one); :func:`run_ranks`
is one call on a pool of its own, with every rank's result.

Backends: NCCL where every rank has its own card, gloo on the CPU and for
ranks that share a card (NCCL refuses two ranks on one GPU); gloo moves a
CUDA tensor's sums through the host.  The choice is printed.
"""

from __future__ import annotations

import datetime
import io
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..config import MapParams, ModelConfig, NewtonConfig
from ..model.emap import event_driven_map, make_residual_fn
from ..solvers.newton import NewtonResult, newton_solve
from ..utils.profiling import span, spanned

# seconds a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 300.0
# seconds a closing pool waits for a rank to exit before it kills it
JOIN_TIMEOUT_S = 60.0

# every all-reduce of a ShardGroup in this process, and the bytes they
# moved (each rank's contribution), counted traced or not
ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0


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
    the group's all-reduces, each a ``parallel.all_reduce`` span
    (:mod:`..utils.profiling`); the module's ``ALL_REDUCES`` and
    ``ALL_REDUCE_BYTES`` count every group's.
    """

    def __init__(self, n_real: int):
        if not dist.is_initialized():
            raise RuntimeError("ShardGroup needs an initialised process "
                               "group (a RankPool's rank)")
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
        global ALL_REDUCES, ALL_REDUCE_BYTES
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if flat.is_cuda and self.backend == "gloo":
            host = flat.cpu()
            dist.all_reduce(host)
            flat = host.to(flat.device)
        else:
            dist.all_reduce(flat)
        self.reduces += 1
        ALL_REDUCES += 1
        ALL_REDUCE_BYTES += flat.numel() * flat.element_size()
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


def _gathered(fn: Callable, *args) -> list:
    buf = io.BytesIO()
    torch.save(fn(*args), buf)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, buf.getvalue())
    return [torch.load(io.BytesIO(b), map_location="cpu", weights_only=False)
            for b in out]


def run_ranks(fn: Callable, world_size: int, *args,
              device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
              workdir: Optional[str] = None) -> list:
    """Run ``fn(*args)`` once on ``world_size`` ranks, on a
    :class:`RankPool` of its own (this process is rank 0; the pool is
    closed on return), and return the list of their results (rank order,
    loaded onto the CPU).

    ``fn`` and ``args`` must pickle (a module-level function); ``fn``
    makes its :class:`ShardGroup`.  When a rank raises or dies, the call
    raises a ``RuntimeError`` with the traceback of the rank that failed
    first (:meth:`RankPool.gather`).
    """
    with RankPool(world_size, device, timeout_s=timeout_s,
                  workdir=workdir) as pool:
        return pool.gather(fn, *args)


def _exit_with(caller: int) -> None:
    """Exit this process once ``caller``, its parent, is gone: a rank
    whose caller died is never left behind."""
    while os.getppid() == caller:
        time.sleep(0.5)
    os._exit(1)


def _reply(conn, fn: Callable, *args) -> bool:
    """Run ``fn(*args)`` and tell the caller how it ended: ``("ok",
    None)``, or ``("error", (time, traceback))``."""
    try:
        fn(*args)
    except BaseException:
        conn.send(("error", (time.time(), traceback.format_exc())))
        return False
    conn.send(("ok", None))
    return True


def _run_task(task: bytes) -> None:
    fn, args, kwargs = pickle.loads(task)
    fn(*args, **kwargs)


def _pool_rank(rank: int, world_size: int, init_method: str,
               device_type: str, timeout_s: float, threads: int, conn,
               caller: int) -> None:
    """Rank ``rank`` of a :class:`RankPool`: join the group, then run each
    call the caller sends until an empty message stops it; then destroy
    the group.  After a failure it waits to be stopped."""
    threading.Thread(target=_exit_with, args=(caller,), daemon=True).start()
    torch.set_num_threads(threads)
    ok = _reply(conn, _init_ranks, rank, world_size, init_method,
                device_type, timeout_s)
    while True:
        try:
            task = conn.recv_bytes()
        except EOFError:
            return
        if not task:
            break
        if ok:
            ok = _reply(conn, _run_task, task)
    if ok:
        dist.destroy_process_group()


def _release(conns: list, procs: list, directory: str) -> None:
    """Stop a pool's ranks: tell each to stop, destroy this process's
    group (NCCL's destroy waits for every rank), join each rank (one that
    does not exit in ``JOIN_TIMEOUT_S`` is killed) and remove the store's
    folder.  After a failure the ranks are dead already."""
    for conn in conns:
        try:
            conn.send_bytes(b"")
        except OSError:                # a rank that was killed
            pass
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except RuntimeError:           # a gloo group whose peers are gone
            pass
    for proc in procs:
        proc.join(timeout=JOIN_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
    for conn in conns:
        conn.close()
    shutil.rmtree(directory, ignore_errors=True)


def _abort_group() -> None:
    """Abort this process's NCCL group, so that a collective it waits in
    ends (a gloo collective ends by itself once its peers are gone)."""
    try:
        if dist.is_initialized() and dist.get_backend() == "nccl":
            dist.distributed_c10d._abort_process_group()
    except (RuntimeError, ValueError):      # already aborted or destroyed
        pass


class RankPool:
    """Ranks that outlive a call: ``world_size`` ranks in ONE process
    group for the pool's whole life.  The calling process is rank 0 (on
    ``cuda:0``, or the CPU); ranks 1 .. ``world_size - 1`` are started
    once with ``spawn`` (CUDA cannot be forked), rank r on ``cuda:r``
    modulo the cards (the backend as :func:`choose_backend` picks it).
    On ``"cuda"`` the kernel library is built here first, so the ranks
    only load it.  They meet at a ``file://`` store in a fresh temporary
    directory (inside ``workdir`` if given), and each of ranks 1 .. takes
    an equal share of this process's CPU threads.

    :meth:`run` runs ``fn(*args, **kwargs)`` on every rank and returns
    rank 0's result.  ``fn`` and its arguments go to the other ranks
    pickled by value (a module-level function; a tensor is copied, so
    make large ones on each rank).  While a call runs, a thread of rank 0
    watches the other ranks; when one raises or dies, the others are
    killed and rank 0's group aborted, so that rank 0 leaves any
    collective it waits in, and the call raises a ``RuntimeError`` with
    the traceback of the rank that failed first (an interrupt or exit of
    rank 0 is raised as itself).  A failed call, or a failed start,
    closes the pool.  A rank whose caller died exits by itself.

    :meth:`close` (also at the end of a ``with`` block, when the pool is
    collected, and at the interpreter's exit) stops the ranks in order:
    rank 0 destroys the group (NCCL's destroy waits for every rank), then
    joins the others.
    The pool's spans: ``parallel.start``, ``parallel.dispatch`` (a call
    sent to the other ranks) and ``parallel.collect`` (rank 0 waiting for
    their replies after its own part).
    """

    def __init__(self, world_size: int, device: str = "cuda", *,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 workdir: Optional[str] = None):
        if world_size < 1:
            raise ValueError(f"world_size must be positive; got "
                             f"{world_size}")
        if dist.is_initialized():
            raise RuntimeError("this process is already in a process group")
        self.world_size = world_size
        self.device_type = torch.device(device).type
        self.backend = choose_backend(self.device_type, world_size)
        self._failures = []
        self._lock = threading.Lock()
        self._conns, self._procs = [], []
        if self.device_type == "cuda":
            from .._build import load_library
            load_library()
        self._dir = tempfile.mkdtemp(prefix="atorch_pool_", dir=workdir)
        init_method = Path(self._dir, "store").as_uri()
        ctx = multiprocessing.get_context("spawn")
        threads = max(1, torch.get_num_threads() // world_size)
        self._stop = weakref.finalize(self, _release, self._conns,
                                      self._procs, self._dir)
        with span("parallel.start"):
            for rank in range(1, world_size):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(
                    target=_pool_rank, name=f"rank{rank}", daemon=True,
                    args=(rank, world_size, init_method, self.device_type,
                          timeout_s, threads, theirs, os.getpid()))
                proc.start()
                theirs.close()
                self._conns.append(mine)
                self._procs.append(proc)
            self._call(_init_ranks, 0, world_size, init_method,
                       self.device_type, timeout_s)

    @property
    def closed(self) -> bool:
        return not self._stop.alive

    @property
    def pids(self) -> list:
        """The process ids of ranks 1 .. ``world_size - 1``."""
        return [p.pid for p in self._procs]

    def run(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` on every rank; rank 0's result."""
        if self.closed:
            raise RuntimeError("the pool is closed")
        with span("parallel.dispatch"):
            task = pickle.dumps((fn, args, kwargs))
            for conn in self._conns:
                conn.send_bytes(task)
        return self._call(fn, *args, **kwargs)

    def gather(self, fn: Callable, *args) -> list:
        """``fn(*args)`` on every rank; every rank's result, in rank
        order, loaded onto the CPU (``torch.save``, then ``torch.load``
        with ``map_location="cpu"``)."""
        return self.run(_gathered, fn, *args)

    def _call(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` here while a thread waits for the other
        ranks' replies to the call they were sent."""
        watcher = threading.Thread(target=self._watch, daemon=True)
        watcher.start()
        out = interrupt = None
        try:
            out = fn(*args, **kwargs)
        except BaseException as err:
            self._failed(time.time(), 0, traceback.format_exc())
            if not isinstance(err, Exception):     # an interrupt or an exit
                interrupt = err
        with span("parallel.collect"):
            watcher.join()
        if self._failures:
            self._stop()
            if interrupt is not None:
                raise interrupt
            _, rank, trace = min(self._failures)
            raise RuntimeError(f"rank{rank} failed first:\n{trace}")
        return out

    def _watch(self) -> None:
        """Read one reply from every other rank; a reply of an error, or
        a rank that exits, fails the call."""
        waiting = dict(zip(self._conns, range(1, self.world_size)))
        sentinels = {p.sentinel: r for r, p in enumerate(self._procs, 1)}
        while waiting:
            ready = multiprocessing.connection.wait(
                list(waiting) + [s for s, r in sentinels.items()
                                 if r in waiting.values()])
            # a rank's reply before its exit: the reply has the traceback
            ready.sort(key=lambda x: x not in waiting)
            for obj in ready:
                if obj in waiting:
                    rank = waiting.pop(obj)
                    try:
                        kind, payload = obj.recv()
                    except (EOFError, OSError):
                        kind, payload = "error", (
                            time.time(), f"rank{rank} closed its pipe")
                    if kind == "error":
                        when, trace = payload
                        self._failed(when, rank, trace)
                        return
                elif sentinels[obj] in waiting.values():
                    rank = sentinels[obj]
                    self._failed(time.time(), rank, (
                        f"rank{rank} exited with code "
                        f"{self._procs[rank - 1].exitcode}"))
                    return

    def _failed(self, when: float, rank: int, trace: str) -> None:
        """Record a failure; at the first, kill the other ranks and abort
        rank 0's group, so that no rank waits in a collective."""
        with self._lock:
            self._failures.append((when, rank, trace))
            if len(self._failures) > 1:
                return
        for proc in self._procs:
            proc.kill()
        _abort_group()

    def close(self) -> None:
        """Stop the ranks (:func:`_release`); closing twice does
        nothing."""
        self._stop()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
