"""Traffic of whole continuation sweeps sharded over four cards, through
the program's CLI on a pool of ranks that outlives the sweeps.

The pool (the program's ``parallel.RankPool``) starts once, in
``Driver.__init__``: the harness process is rank 0 on card 0, ranks 1-3
are spawned once, rank r on card r, in one NCCL group.  Sweep ``k`` then
runs as ``cli_sweep`` runs it (:mod:`benchmark.loops.cli_sweep`: the
same flags, a fresh ``--checkpoint`` directory under ``TMPDIR``, the
steps read back after the window) with ``cli.driver.main(argv,
draw=..., pool=...)``, the traffic's ``--shard 4`` in its flags: step
``i``'s draw comes from ``stream_seed(seed, "sweep", k, i)``, made whole
on every rank's own card, and every rank keeps its rows.  Rank 0 alone
writes the checkpoints.  The answers are checked as ``cli_sweep``
checks them, by the plain reference at the configuration's R on card 0.

``devices()`` gathers every rank's ``local_devices``; ``counters()``
adds the program's all-reduce counters to the launch counters (rank 0's:
every all-reduce is one collective of all four ranks).  A fault of
:mod:`benchmark.faults` planted in the harness process before the pool
starts (the CPU tests, ``control.py --fault``) is planted on the other
ranks too, so that the ranks stay in step around each collective.  The
pool is imported before anything starts, so a program without one fails
at once and spawns no rank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from armadillocudalinearinterpolation_torch.parallel import RankPool, sharding
from benchmark import answers, faults
from benchmark.loops import cli_sweep
from benchmark.yardstick import stream_seed

CHIPS = 4
# the program's attributes that benchmark.faults replaces, and the fault
# each replacement stands for, by the name of the faults.py function
# that made it
FAULT_SITES = (("cli.driver", "newton_solve"), ("model.emap",
               "masked_ensemble_mean"), ("cli.driver", "count_unstable"))
FAULT_OF = {"plant": "unchanged", "altered": "altered",
            "half_batch": "half_batch", "off_by_one": "stability"}


class StreamDraw:
    """A sweep's ``draw(step, params)`` that pickles: the rates at the
    step's mean rate, from the stream's generator, on the calling rank's
    own card (or the CPU)."""

    def __init__(self, config: dict, stream: tuple, device_type: str):
        self.config, self.stream = config, stream
        self.device_type = device_type

    def __call__(self, step, params):
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self.device_type == "cuda" else torch.device("cpu"))
        gen = torch.Generator(device=device).manual_seed(
            stream_seed(*self.stream, step))
        return answers.draw_rates(self.config, params.beta, gen, device)


def planted() -> list:
    """The faults of :mod:`benchmark.faults` planted in this process."""
    import importlib
    out = []
    for module, name in FAULT_SITES:
        value = getattr(importlib.import_module(
            f"armadillocudalinearinterpolation_torch.{module}"), name)
        if getattr(value, "__module__", None) == faults.__name__:
            out.append(FAULT_OF[value.__qualname__.split(".")[0]])
    return out


def plant_beyond_rank_0(names: list) -> None:
    """Plant the faults ``names`` on this rank unless it is rank 0, where
    they are planted already (as in a ``cli_sweep`` cell: the sharded
    loop runs the same CLI)."""
    if dist.get_rank() > 0:
        for name in names:
            faults.plant(name, "cli_sweep")


def rank_devices(device_type: str) -> list:
    """Every rank's ``local_devices``, gathered on every rank."""
    from benchmark.harness import local_devices
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, local_devices(device_type))
    return [card for rank in out for card in rank]


def newton_batch(m, Z0: torch.Tensor, means: list, rates: torch.Tensor, *,
                 tol: float, max_iter: int, eps: float, store) -> list:
    """:func:`benchmark.reference.edmap.newton` on ``P`` problems at once
    (starts ``Z0`` ``(P, M)``, rates ``(P, R, N)``): each iteration
    evaluates every unfinished problem's point and its ``M`` forward
    differences in one call of the reference, whose rows are independent,
    so each problem ends as it would alone.  Returns each problem's
    ``converged``."""
    from benchmark.reference import edmap
    P, M = Z0.shape
    e = eps * torch.eye(M, dtype=Z0.dtype, device=Z0.device)
    z, it = Z0.clone(), 0
    converged = [False] * P
    todo = list(range(P))
    while todo:
        pts = torch.cat([z[todo, None], z[todo, None] + e[None]], dim=1)
        mean = torch.tensor([means[p] for p in todo for _ in range(M + 1)],
                            dtype=Z0.dtype, device=Z0.device)
        f = edmap.residual(
            m, pts.reshape(-1, M), mean,
            rates[todo].repeat_interleave(M + 1, dim=0),
            store=store).reshape(len(todo), M + 1, M)
        norms = torch.linalg.vector_norm(f[:, 0], dim=1).tolist()
        going = []
        for q, p in enumerate(todo):
            norm = norms[q]
            if norm <= tol or it == max_iter or norm != norm:
                converged[p] = norm <= tol
                continue
            jac = (f[q, 1:] - f[q, 0]).T / eps
            z[p] = z[p] + torch.linalg.solve(jac, -f[q, 0])
            going.append(p)
        todo, it = going, it + 1
    return converged


class Driver(cli_sweep.Driver):
    work_unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 chips: int = 1):
        if chips != CHIPS:
            raise ValueError(f"sharded_sweep runs its sweeps on {CHIPS} "
                             f"cards; the cell asks for {chips}")
        # the one-card loop's flags, draws' seeds and checkpoint folder
        super().__init__(config, traffic, seed, device)
        if self.args["shard"] != chips:
            raise ValueError(f"the traffic shards over {self.args['shard']} "
                             f"ranks; the cell has {chips} cards")
        self.pool = RankPool(chips, self.device.type)
        names = planted()
        if names:
            self.pool.run(plant_beyond_rank_0, names)
        self.main = functools.partial(self.main, pool=self.pool)

    def draws(self, *stream):
        return StreamDraw(self.config, stream, self.device.type)

    def devices(self) -> list:
        return self.pool.run(rank_devices, self.device.type)

    def counters(self) -> dict:
        return dict(answers.launch_counters(),
                    all_reduces=sharding.ALL_REDUCES,
                    all_reduce_bytes=sharding.ALL_REDUCE_BYTES)

    def release(self) -> None:
        self.pool.close()
        super().release()

    def control(self, records: list) -> dict:
        """``cli_sweep``'s control (the reference in bfloat16 storage in
        the program's place) with the checked steps side by side: their
        residuals and forward differences in one evaluation, their Newton
        solves in one batch (:func:`newton_batch`)."""
        from benchmark.reference import edmap
        m = answers.reference_model(self.config)
        eps, store = self.args["fd_eps"], torch.bfloat16
        done = [dict(s, k=r["k"]) for r in records for s in r["steps"]
                if s["converged"]]
        picked = answers.sample(done, self.traffic["checked"], self.seed)
        prev = {(r["k"], s["index"]): s["solution"] for r in records
                for s in r["steps"]}
        rates = torch.stack([answers.draw_rates(
            self.config, s["beta"], torch.Generator(
                device=self.device).manual_seed(stream_seed(
                    self.seed, "sweep", s["k"], s["index"])), self.device)
            for s in picked])
        solutions = torch.from_numpy(np.stack([s["solution"]
                                               for s in picked]))
        Z = solutions.to(torch.float32).to(self.device)
        P, M = Z.shape
        pts = torch.cat([Z[:, None], Z[:, None] + eps * torch.eye(
            M, device=self.device)[None]], dim=1)
        f = edmap.residual(
            m, pts.reshape(-1, M), torch.tensor(
                [s["beta"] for s in picked for _ in range(M + 1)],
                device=self.device),
            rates.repeat_interleave(M + 1, dim=0),
            store=store).reshape(P, M + 1, M)
        claims = torch.linalg.vector_norm(f[:, 0], dim=1).tolist()
        counts = []
        for p in range(P):
            jac = ((f[p, 1:] - f[p, 0]).T / eps).double().cpu().numpy()
            # a Jacobian that is not finite gives no count: a mismatch
            counts.append(answers.unstable_count(jac, 0.0)[0]
                          if np.isfinite(jac).all() else -1)
        starts = torch.tensor(np.stack([
            prev.get((s["k"], s["index"] - 1), self.args["guess"])
            for s in picked]), dtype=torch.float32, device=self.device)
        converged = newton_batch(
            m, starts, [s["beta"] for s in picked], rates,
            tol=self.args["tol"], max_iter=self.args["max_iter"], eps=eps,
            store=store)
        out = answers.sweep_numbers(
            self.config, solutions, claims,
            [s["beta"] for s in picked], rates, eps, counts,
            self.traffic["stability_margin"])
        out["unconverged_share"] = (100.0 * converged.count(False)
                                    / len(converged))
        return out
