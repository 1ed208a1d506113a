#!/usr/bin/env python3
"""Three Jacobians of the direct map at a loose root tolerance, on the CPU.

    python3 tools/loose_root_study.py [--root-tol 1e-6] [--steps 1e-5,1e-6]

At the near-fold point of ``tests/test_fold.py`` (N=512, R=4, sigma 0, f64,
Z = (0.59145, 0.57176, 10.07225), beta 20.32) it computes

* the port's exact Jacobian on its direct plain evolve
  (``F.value_and_jacobian`` with ``evolve_backend="torch"``);
* JAX ``jacfwd_cols`` through the JAX package's ``"xla"`` evolve (the IFT
  tangents at the evolve's own roots);
* a central finite difference of the port's own ``F`` at each step given,

with the beta column, and prints one JSON object: each Jacobian, and the
largest gap between each pair relative to the largest entry of JAX's.
Imports JAX (pinned to the CPU with x64) and both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

Z_FOLD, BETA_FOLD = (0.59145, 0.57176, 10.07225), 20.32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root-tol", type=float, default=1e-6)
    ap.add_argument("--steps", default="1e-5,1e-6,1e-7")
    args = ap.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    import armadillocudalinearinterpolation_tpu as jx
    import armadillocudalinearinterpolation_torch as pt
    from armadillocudalinearinterpolation_tpu.model.emap import (
        event_driven_map as jax_map)
    from armadillocudalinearinterpolation_tpu.solvers.newton import (
        jacfwd_cols)
    torch.set_num_threads(1)

    key = jax.random.PRNGKey(0)
    jcfg = jx.ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                          root_tol=args.root_tol)
    pcfg = pt.ModelConfig(n_neurons=512, n_real=4, dtype="float64",
                          root_tol=args.root_tol)
    noise = np.asarray(jax.random.normal(key, (4, 512), dtype=jnp.float64))

    def G(y):
        return jax_map(jcfg, jx.MapParams(beta=y[3], sigma=jnp.asarray(
            0.0, jnp.float64)), key, y[:3], evolve_backend="xla")

    y = jnp.asarray(Z_FOLD + (BETA_FOLD,), jnp.float64)
    J_jax = np.asarray(jax.jit(jacfwd_cols(G))(y))

    def port_F(beta):
        return pt.make_residual_fn(
            pcfg, pt.MapParams.create(beta, 0.0, dtype="float64"), 0,
            device="cpu", noise=torch.tensor(noise), evolve_backend="torch")

    z = torch.tensor(Z_FOLD, dtype=torch.float64)
    _, J_port = port_F(BETA_FOLD).value_and_jacobian(z, param="beta")
    J_port = J_port.numpy()

    F0 = port_F(BETA_FOLD)
    J_fd = {}
    for h in (float(x) for x in args.steps.split(",")):
        cols = []
        for i in range(3):
            e = torch.zeros(3, dtype=torch.float64)
            e[i] = h
            cols.append(((F0(z + e) - F0(z - e)) / (2 * h)).numpy())
        cols.append(((port_F(BETA_FOLD + h)(z)
                      - port_F(BETA_FOLD - h)(z)) / (2 * h)).numpy())
        J_fd[h] = np.stack(cols, axis=1)

    scale = float(np.abs(J_jax).max())

    def gap(a, b):
        return float(np.abs(a - b).max() / scale)

    out = {"root_tol": args.root_tol, "point": list(Z_FOLD),
           "beta": BETA_FOLD, "max_abs_J_jax": scale,
           "J_port": J_port.tolist(), "J_jax": J_jax.tolist(),
           "port_vs_jax": gap(J_port, J_jax),
           "fd": {str(h): {"J": J.tolist(), "vs_jax": gap(J, J_jax),
                           "vs_port": gap(J, J_port)}
                  for h, J in J_fd.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
