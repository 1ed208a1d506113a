"""Port parity of the ensemble evolve: the plain PyTorch loop against the
JAX package's XLA evolve (f64) and its Pallas kernel in interpret mode
(f32), and the CUDA kernel's wrapper checks that need no card (the kernel
itself is held against the plain evolve in ``test_torch_cuda.py``).

Inputs are the JAX ``sample_beta`` draw and lifts of the ``Driver.cu``
guess and its forward-FD perturbations, fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (INITIAL_GUESS, configs, interpreted,  # noqa: F401
                          jax_draw, jx, params, pt, to_numpy, to_torch)
from armadillocudalinearinterpolation_torch.model import evolve_cuda

# stack of P=4 points: the guess and its three forward-FD perturbations
POINTS = np.asarray(INITIAL_GUESS)[None, :] + np.vstack(
    [np.zeros(3), 1e-2 * np.eye(3)])


def lifted_stack(pcfg, pp, Z):
    Zt = torch.tensor(Z, dtype=pcfg.torch_dtype)
    v0, s0 = pt.lift(pcfg, pp, pt.z_to_u(Zt))
    return Zt, v0, s0, pt.initial_spike_indices(pcfg, Zt)


def test_plain_evolve_matches_xla_evolve_f64():
    """f64, N=512, R=4, sigma=0.1: indices, accept and n_events identical,
    times to 1e-10 (the replay bar, tests/test_replay.py:51)."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    jp, pp = params(sigma=0.1)
    beta = jax_draw(jcfg, jp)
    _, v0, s0, init_ind = lifted_stack(pcfg, pp, POINTS)
    res = pt.evolve_ensemble(pcfg, v0, s0, to_torch(beta), init_ind)
    R = jcfg.n_real
    evolve = jax.jit(jax.vmap(lambda v, s, i: jx.evolve_ensemble(
        jcfg, jx.coupling_kernel(jcfg), v, s, jnp.asarray(beta), i)))
    refs = evolve(*(jnp.asarray(to_numpy(x)) for x in (v0, s0, init_ind)))
    for p in range(len(POINTS)):
        ref = jax.tree.map(lambda x: x[p], refs)
        rows = slice(p * R, (p + 1) * R)
        for name in ("last_ind", "crossed_ind", "accept", "n_events"):
            np.testing.assert_array_equal(
                to_numpy(getattr(res, name)[rows]),
                np.asarray(getattr(ref, name)), err_msg=name)
        for name in ("last_time", "crossed_time"):
            np.testing.assert_allclose(
                to_numpy(getattr(res, name)[rows]),
                np.asarray(getattr(ref, name)), rtol=0, atol=1e-10,
                err_msg=name)
    assert bool(res.accept.all())
    assert int(res.n_events.min()) > 100


def test_plain_evolve_f32_matches_pallas_kernel_interpreted(interpreted):
    """f32, N=256, R=4, sigma=0.1: the residual of the plain evolve agrees
    with the JAX map on the Pallas kernel to 2e-5, the kernel's own bar
    (tests/test_evolve_pallas.py:91)."""
    jcfg, pcfg = configs(n_neurons=256, n_real=4, dtype="float32")
    jp, pp = params(sigma=0.1, dtype="float32")
    key = jax.random.PRNGKey(0)
    z = np.asarray(INITIAL_GUESS, np.float32)
    f_pallas = jx.event_driven_map(jcfg, jp, key, jnp.asarray(z),
                                   evolve_backend="pallas")
    f_plain = pt.event_driven_map(pcfg, pp, to_torch(jax_draw(jcfg, jp)),
                                  torch.tensor(z), evolve_backend="torch")
    assert f_plain.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(f_plain), np.asarray(f_pallas),
                               rtol=0, atol=2e-5)


def test_plain_evolve_of_a_stack_is_each_point_alone():
    """Row p*R + r of a P-point evolve is point p under realisation r."""
    _, pcfg = configs(n_neurons=256, n_real=3)
    _, pp = params(sigma=0.1)
    beta = 13.0589 + 0.1 * torch.from_numpy(
        np.random.default_rng(4).standard_normal((3, 256)))
    _, v0, s0, init_ind = lifted_stack(pcfg, pp, POINTS[:2])
    both = pt.evolve_ensemble(pcfg, v0, s0, beta, init_ind)
    for p in range(2):
        one = pt.evolve_ensemble(pcfg, v0[p:p + 1], s0[p:p + 1], beta,
                                 init_ind[p:p + 1])
        for a, b in zip(both, one):
            assert torch.equal(a[3 * p:3 * (p + 1)], b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_row_where_nothing_fires_matches_xla_evolve(dtype):
    """No lane can fire: the one event is the +100 sentinel at lane 0, which
    ends the row past 2T unaccepted; every field is finite and equals the
    JAX evolve's."""
    jcfg, pcfg = configs(n_neurons=256, n_real=2, dtype=dtype)
    v0 = np.zeros(256)
    beta = np.full((2, 256), 13.0589)
    init_ind = np.array([128, 100, 80], np.int32)
    res = pt.evolve_ensemble(
        pcfg, *(to_torch(x[None], dtype) for x in (v0, v0)),
        to_torch(beta, dtype), torch.tensor(init_ind[None]))
    ref = jx.evolve_ensemble(jcfg, jx.coupling_kernel(jcfg),
                             *(jnp.asarray(x, dtype) for x in (v0, v0, beta)),
                             jnp.asarray(init_ind))
    for name, got in res._asdict().items():
        assert bool(torch.isfinite(got.double()).all()), name
        np.testing.assert_array_equal(to_numpy(got),
                                      np.asarray(getattr(ref, name)), name)
    assert res.n_events.tolist() == [1, 1] and not bool(res.accept.any())


@pytest.mark.parametrize("bad", ["shape", "dtype", "init_dtype", "device"])
def test_evolve_rejects_bad_inputs(bad):
    _, pcfg = configs(n_neurons=256, n_real=2)
    v0 = torch.zeros(1, 256, dtype=torch.float64)
    s0, beta = v0.clone(), torch.ones(2, 256, dtype=torch.float64)
    init_ind = torch.zeros(1, 3, dtype=torch.int32)
    if bad == "shape":
        v0 = v0[:, :128]
    elif bad == "dtype":
        s0 = s0.float()
    elif bad == "init_dtype":
        init_ind = init_ind.long()
    with pytest.raises((ValueError, TypeError)):
        if bad == "device":
            evolve_cuda.evolve_ensemble_cuda(pcfg, v0, s0, beta, init_ind)
        else:
            pt.evolve_ensemble(pcfg, v0, s0, beta, init_ind)


def test_cuda_wrapper_refuses_cpu_tensors_without_launching():
    _, pcfg = configs(n_neurons=256, n_real=2)
    before = evolve_cuda.LAUNCHES
    x = torch.zeros(1, 256, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        evolve_cuda.evolve_ensemble_cuda(
            pcfg.with_(dtype="float32"), x, x, torch.ones(2, 256),
            torch.zeros(1, 3, dtype=torch.int32))
    assert evolve_cuda.LAUNCHES == before
