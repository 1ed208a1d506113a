"""Parity helpers: run the same inputs through the JAX package and the
PyTorch port.

The heterogeneity draw is made once with the JAX ``sample_beta`` and fed to
both packages ("same draw"), so the two random number generators never have
to agree.  Arrays cross between the packages as numpy arrays.  Import this
after ``conftest.py`` has pinned JAX to the CPU with x64 on.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import armadillocudalinearinterpolation_tpu as jx
import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_tpu.model.emap import (
    sample_beta as jax_sample_beta)
from armadillocudalinearinterpolation_torch import interop

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)    # Driver.cu initial guess

# The plain evolve runs thousands of small ops on (rows, N) tensors: one
# thread each is fastest, and keeps the test workers from oversubscribing
# the cores that JAX shares.
torch.set_num_threads(1)


def to_numpy(x) -> np.ndarray:
    """A numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_jax(x, dtype=None) -> jax.Array:
    return jnp.asarray(to_numpy(x), dtype=dtype)


def to_torch(x, dtype=None) -> torch.Tensor:
    return interop.tensor_from_numpy(to_numpy(x), dtype)


def configs(dtype="float64", **kw):
    """The same model configuration in both packages."""
    jcfg = jx.ModelConfig(dtype=dtype, **kw)
    return jcfg, interop.config_from_fields(dataclasses.asdict(jcfg))


def params(beta=13.0589, sigma=0.1, dtype="float64"):
    """The same ``MapParams`` in both packages."""
    return (jx.MapParams.create(beta, sigma, dtype=dtype),
            interop.params_from_numpy(beta, sigma, dtype=dtype))


def jax_draw(jcfg, jparams, seed=0) -> np.ndarray:
    """The ``(R, N)`` draw of the JAX ``sample_beta`` for ``PRNGKey(seed)``,
    the draw both packages' maps use at that key."""
    return np.asarray(jax_sample_beta(jcfg, jparams,
                                      jax.random.PRNGKey(seed)))


@pytest.fixture
def interpreted(monkeypatch):
    """The JAX package's Pallas evolve kernel through the Pallas
    interpreter, as tests/test_evolve_pallas.py runs it on the CPU."""
    import armadillocudalinearinterpolation_tpu.model.evolve_pallas as ep

    monkeypatch.setattr(ep, "_INTERPRET", True)
    monkeypatch.setattr(ep, "_BLOCK_ELEMENT_BUDGET", 8 * 512)
    ep.evolve_ensemble_pallas.clear_cache()
    yield ep
    ep.evolve_ensemble_pallas.clear_cache()
