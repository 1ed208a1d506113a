"""Measure a configuration's events per row with the reference map: the
mean over the realisations of the events a row takes at a start point,
under the draw of seed 0 (a CPU generator).  The roofline shares take
this constant from the configuration's file, or from the traffic's file
where the traffic starts elsewhere.

Run from the root of the checkout:

    python3 benchmark/events_per_row.py ring_n4096_r64_f64
    python3 benchmark/events_per_row.py ring_n512_r1000_f32 \
        --traffic sweep_fast_family
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import answers  # noqa: E402
from benchmark.reference import edmap  # noqa: E402


def measure(config: dict, guess, beta: float) -> float:
    gen = torch.Generator().manual_seed(0)
    rates = answers.draw_rates(config, beta, gen, "cpu")
    Z = torch.tensor([guess], dtype=torch.float64)
    _, out = edmap.residual(answers.reference_model(config), Z,
                            torch.tensor([beta], dtype=torch.float64),
                            rates[None], outcome=True)
    return float(out.n_events.double().mean())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--traffic", help="take the start from this traffic")
    a = p.parse_args()
    config = json.loads((ROOT / "benchmark" / "configs"
                         / f"{a.config}.json").read_text())
    guess, beta = config["guess"], config["beta"]
    if a.traffic:
        start = json.loads((ROOT / "benchmark" / "traffic"
                            / f"{a.traffic}.json").read_text())["start"]
        guess, beta = start["guess"], start["beta"]
    print(json.dumps({"config": a.config, "guess": guess, "beta": beta,
                      "events_per_row": measure(config, guess, beta)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
