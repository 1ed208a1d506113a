"""Traffic of closed-loop staged solves: one caller solves the map to the
configuration's tolerance with ``newton_solve_staged``, waits for the
answer, and asks again.

The caller works through a pool of ``traffic["pool"]`` problems, one pass
a unit of work.  Problem ``i`` has its own ``(R, N)`` draw of the rates
and its own start, the configuration's guess plus a uniform perturbation
in ``[-p, p]`` on every component, both from a generator on the device
seeded with ``stream_seed("pool", i)``; the run's seed orders each pass
(``stream_seed(seed, "pass", k)``).  So every seed does the same work in
another order: which draws the solver fails on changes the time of a
solve eightfold, and a window of fresh draws swung with them.  The traffic
file names the accurate stage (``"frozen-fwd"``: the replay backend and
its frozen stencil, the library's default; ``"exact"``: exact Jacobians
on the direct evolve), the perturbation, the pool, and how many answers a
run checks.
"""

from __future__ import annotations

import random

import torch

from benchmark import answers
from benchmark.yardstick import stream_seed

# the accurate stage's evolve backend, on the card and on the CPU (tests)
STAGE2_BACKENDS = {"frozen-fwd": {"cuda": "replay", "cpu": "replay"},
                   "exact": {"cuda": "cuda", "cpu": "torch"}}


class Driver:
    work_unit = "solve"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 chips: int = 1):
        if chips != 1:
            raise ValueError(f"staged_solve runs its solves on one card; "
                             f"the cell asks for {chips}")
        import armadillocudalinearinterpolation_torch as pt
        self.pt = pt
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cfg = pt.ModelConfig(**answers.program_config(config))
        self.dtype = self.cfg.torch_dtype
        self.params = pt.MapParams.create(config["beta"], config["sigma"],
                                          dtype=self.cfg.dtype,
                                          device=self.device)
        self.backend = STAGE2_BACKENDS[traffic["stage2"]][self.device.type]
        self.tolerance = config["tolerance"]

    def inputs(self, stream: int):
        """The draw and the start of one solve, from the generator seed
        ``stream``."""
        gen = torch.Generator(device=self.device).manual_seed(stream)
        rates = answers.draw_rates(self.config, self.config["beta"], gen,
                                   self.device)
        p = self.traffic["perturbation"]
        guess = torch.tensor(self.config["guess"], dtype=self.dtype,
                             device=self.device)
        return rates, guess + (2.0 * torch.rand(
            guess.shape, generator=gen, dtype=self.dtype,
            device=self.device) - 1.0) * p

    def solve(self, rates, z0):
        return self.pt.newton_solve_staged(
            self.cfg, self.params, z0, beta=rates, tolerance=self.tolerance,
            evolve_backend=self.backend)

    def warm_up(self) -> None:
        # the same work whatever the seed: one solve of a fixed stream
        self.solve(*self.inputs(stream_seed("warm-up")))

    def unit(self, k: int) -> dict:
        """One pass over the pool, in the order of pass ``k``."""
        order = list(range(self.traffic["pool"]))
        random.Random(stream_seed(self.seed, "pass", k)).shuffle(order)
        solves = []
        for i in order:
            res = self.solve(*self.inputs(stream_seed("pool", i)))
            solves.append({"i": i, "converged": bool(res.converged),
                           "solution": res.solution.detach().double().cpu(),
                           "iterations": int(res.iterations),
                           "residual_norm": float(res.residual_norm)})
        failed = sum(not s["converged"] for s in solves)
        return {"k": k, "solves": solves, "attempted": len(solves),
                "work": len(solves), "failed": failed,
                "iterations": [s["iterations"] for s in solves]}

    def counters(self) -> dict:
        return answers.launch_counters()

    def release(self) -> None:
        self.params = None

    def check(self, records: list) -> dict:
        """The numbers that decide ``correct`` (:mod:`benchmark.answers`)
        at the checked answers: of the solves reported converged, the one
        with the largest reported residual and a draw from the seed of
        the rest, ``traffic["checked"]`` in all."""
        done = [s for r in records for s in r["solves"] if s["converged"]]
        picked = answers.sample(done, self.traffic["checked"], self.seed)
        if not picked:
            return {}
        draws = torch.stack([self.inputs(stream_seed("pool", s["i"]))[0]
                             for s in picked])
        return answers.solve_numbers(
            self.config, torch.stack([s["solution"] for s in picked]),
            [s["residual_norm"] for s in picked],
            [self.config["beta"]] * len(picked), draws)

    def control(self, records: list) -> dict:
        """The program's own float32 path in its place (the nearest
        precision below the configuration's float64): at the checked
        answers the f32 map's residual stands as the claim
        (``claim_gap``); from the checked problems' starts the f32 stage
        alone (central FD Newton, the staged recipe's stage 1) solves to
        the tolerance (``unconverged_share``)."""
        from armadillocudalinearinterpolation_torch.model.replay import (
            schedule_config)
        pt = self.pt
        cfg32 = schedule_config(self.cfg)
        params32 = pt.MapParams.create(self.config["beta"],
                                       self.config["sigma"], dtype="float32",
                                       device=self.device)
        ncfg = pt.NewtonConfig(tolerance=self.tolerance, max_iterations=6,
                               fd_epsilon=1e-3, fd_mode="central")
        done = [s for r in records for s in r["solves"] if s["converged"]]
        picked = answers.sample(done, self.traffic["checked"], self.seed)
        claims, draws, converged = [], [], []
        for s in picked:
            rates, z0 = self.inputs(stream_seed("pool", s["i"]))
            F32 = pt.make_residual_fn(cfg32, params32, 0, device=self.device,
                                      beta=rates.float())
            z = s["solution"].to(device=self.device, dtype=torch.float32)
            claims.append(float(torch.linalg.vector_norm(F32(z))))
            converged.append(bool(pt.newton_solve(F32, z0.float(),
                                                  ncfg).converged))
            draws.append(rates)
        out = answers.solve_numbers(
            self.config, torch.stack([s["solution"] for s in picked]),
            claims, [self.config["beta"]] * len(picked), torch.stack(draws))
        out["unconverged_share"] = (100.0 * converged.count(False)
                                    / len(converged))
        return out
