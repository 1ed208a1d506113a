"""Traffic of whole continuation sweeps through the program's CLI, as the
reference's ``Driver.cu`` runs them: one caller runs a sweep, reads its
checkpointed steps, and starts the next.

Sweep ``k`` of a run calls ``cli.driver.main(argv, draw=...)`` with the
configuration's flags and the traffic's, and a fresh ``--checkpoint``
directory under ``TMPDIR``; step ``i``'s ``(R, N)`` draw comes from a
generator on the device seeded with ``stream_seed(seed, "sweep", k, i)``.
The CLI's printing goes to a null stream.  The traffic file gives the
flags (start, FD step, steps, ``--stability``), the steps of the warm-up
sweep, how many steps a run checks, and the eigenvalue margin of the
stability check.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import answers
from benchmark.yardstick import stream_seed


def flags(config: dict, traffic: dict, device: torch.device) -> list:
    """The CLI's arguments: the configuration's sizes, start and Newton
    settings, then the traffic's start and flags (which override them)."""
    m, newton = config["model"], config["newton"]
    argv = ["--neurons", m["n_neurons"], "--realisations", config["n_real"],
            "--spikes", m["n_spikes"], "--horizon", m["t_horizon"],
            "--dtype", config["dtype"], "--sigma", config["sigma"],
            "--beta", config["beta"], "--guess", *config["guess"],
            "--evolve-window", config["evolve_window"],
            "--max-events", config["max_events"],
            "--root-tol", m["root_tol"],
            "--tol", newton["tolerance"],
            "--max-iter", newton["max_iterations"],
            "--fd-eps", newton["fd_epsilon"],
            "--beta-step", config["beta_step"]]
    start = traffic.get("start")
    if start:
        argv += ["--beta", start["beta"], "--guess", *start["guess"]]
    argv += traffic["flags"]
    if device.type == "cpu":
        argv.append("--cpu")
    return [str(a) for a in argv]


def parse(argv: list) -> dict:
    """The values the CLI takes from ``argv`` that the check needs."""
    from armadillocudalinearinterpolation_torch.cli.driver import build_parser
    return vars(build_parser().parse_args(argv))


def read_steps(path: Path) -> list:
    """The steps a sweep checkpointed (``steps.jsonl`` and one
    ``step_<index>.npz`` a step), latest record per index."""
    index = path / "steps.jsonl"
    if not index.exists():
        return []
    by_index = {}
    for line in index.read_text().splitlines():
        rec = json.loads(line)
        by_index[int(rec["index"])] = rec
    out = []
    for i in sorted(by_index):
        with np.load(path / f"step_{i:05d}.npz") as data:
            out.append(dict(by_index[i], solution=np.array(
                data["solution"], dtype=np.float64)))
    return out


class Driver:
    work_unit = "step"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 chips: int = 1):
        if chips != 1:
            raise ValueError(f"cli_sweep runs its sweeps on one card; "
                             f"the cell asks for {chips}")
        from armadillocudalinearinterpolation_torch.cli import driver
        self.main = driver.main
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.argv = flags(config, traffic, self.device)
        self.args = parse(self.argv)
        self.dir = Path(tempfile.mkdtemp(prefix="sweeps-"))

    def draws(self, *stream):
        """The sweep's ``draw(step, params)``: the rates at the step's
        mean rate, from the stream's generator."""
        def draw(step, params):
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(*stream, step))
            return answers.draw_rates(self.config, params.beta, gen,
                                      self.device)
        return draw

    def sweep(self, name: str, argv: list, draw):
        path = self.dir / name
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            rc = self.main(argv + ["--checkpoint", str(path)], draw=draw)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return rc, path

    def warm_up(self) -> None:
        # the same work whatever the seed: a short sweep of a fixed stream
        argv = self.argv + ["--steps", str(self.traffic["warm_up_steps"])]
        self.sweep("warm-up", argv, self.draws("warm-up"))

    def unit(self, k: int) -> dict:
        rc, path = self.sweep(f"sweep_{k}", self.argv,
                              self.draws(self.seed, "sweep", k))
        return {"k": k, "rc": rc, "path": path}

    def finish(self, records: list) -> None:
        """Read each sweep's steps from its checkpoint (after the window):
        ``attempted`` its planned steps, ``work`` its completed steps,
        ``failed`` the steps that did not converge and those a stopped
        sweep never reached."""
        planned = self.args["steps"]
        for r in records:
            r["steps"] = read_steps(r["path"])
            done = len(r["steps"])
            r["attempted"], r["work"] = planned, done
            r["failed"] = (sum(not s["converged"] for s in r["steps"])
                           + (planned - done))

    def counters(self) -> dict:
        return answers.launch_counters()

    def release(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    def check(self, records: list) -> dict:
        """The numbers that decide ``correct`` (:mod:`benchmark.answers`)
        at the checked steps: of the steps reported converged, the one
        with the largest reported residual and a draw from the seed of
        the rest, ``traffic["checked"]`` in all."""
        done = [dict(s, k=r["k"]) for r in records for s in r["steps"]
                if s["converged"]]
        picked = answers.sample(done, self.traffic["checked"], self.seed)
        if not picked:
            return {}
        draws, Z, claimed, means, counts = [], [], [], [], []
        for s in picked:
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(self.seed, "sweep", s["k"], s["index"]))
            draws.append(answers.draw_rates(self.config, s["beta"], gen,
                                            self.device))
            Z.append(torch.from_numpy(s["solution"]))
            claimed.append(s["residual_norm"])
            means.append(s["beta"])
            counts.append(s["n_unstable"])
        return answers.sweep_numbers(
            self.config, torch.stack(Z), claimed, means, torch.stack(draws),
            self.args["fd_eps"], counts, self.traffic["stability_margin"])

    def control(self, records: list) -> dict:
        """The reference in bfloat16 storage in the program's place (the
        nearest precision below the configuration's float32): at the
        checked steps its residual stands as the claim (``claim_gap``)
        and its forward-difference Jacobian gives the unstable count
        (``stability_mismatch``); from the program's previous step (the
        start at step 0) its Newton solves the step
        (``unconverged_share``)."""
        from benchmark.reference import edmap
        m = answers.reference_model(self.config)
        eps, store = self.args["fd_eps"], torch.bfloat16
        done = [dict(s, k=r["k"]) for r in records for s in r["steps"]
                if s["converged"]]
        picked = answers.sample(done, self.traffic["checked"], self.seed)
        prev = {(r["k"], s["index"]): s["solution"] for r in records
                for s in r["steps"]}
        draws, claims, counts, converged = [], [], [], []
        for s in picked:
            gen = torch.Generator(device=self.device).manual_seed(
                stream_seed(self.seed, "sweep", s["k"], s["index"]))
            rates = answers.draw_rates(self.config, s["beta"], gen,
                                       self.device)
            z = torch.tensor(s["solution"], dtype=torch.float32,
                             device=self.device)
            M = z.shape[0]
            f = edmap.residual(
                m, torch.cat([z[None], z[None] + eps * torch.eye(
                    M, device=self.device)]),
                torch.full((M + 1,), s["beta"], device=self.device),
                rates[None].expand(M + 1, *rates.shape), store=store)
            claims.append(float(torch.linalg.vector_norm(f[0])))
            jac = ((f[1:] - f[0]).T / eps).double().cpu().numpy()
            # a Jacobian that is not finite gives no count: a mismatch
            counts.append(answers.unstable_count(jac, 0.0)[0]
                          if np.isfinite(jac).all() else -1)
            start = prev.get((s["k"], s["index"] - 1), self.args["guess"])
            converged.append(edmap.newton(
                m, torch.tensor(start, dtype=torch.float32,
                                device=self.device), s["beta"], rates,
                tol=self.args["tol"], max_iter=self.args["max_iter"],
                eps=eps, store=store)[2])
            draws.append(rates)
        out = answers.sweep_numbers(
            self.config, torch.stack([torch.from_numpy(s["solution"])
                                      for s in picked]), claims,
            [s["beta"] for s in picked], torch.stack(draws), eps, counts,
            self.traffic["stability_margin"])
        out["unconverged_share"] = (100.0 * converged.count(False)
                                    / len(converged))
        return out
