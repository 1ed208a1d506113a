"""The CUDA evolve kernel on the card, against the plain PyTorch evolve on
the same CUDA tensors.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.model import evolve_cuda
from armadillocudalinearinterpolation_torch.model.emap import (
    assemble_residual)

pytestmark = pytest.mark.cuda

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the evolve kernel has no CPU mode")
    return torch.device("cuda")


def inputs(card, n_neurons, n_real, dtype, n_points=4):
    """The lift of the Driver.cu guess and its forward-FD perturbations, and
    a seeded draw at sigma=0.1, on the card."""
    cfg = pt.ModelConfig(n_neurons=n_neurons, n_real=n_real, dtype=dtype)
    params = pt.MapParams.create(13.0589, 0.1, dtype=dtype, device=card)
    beta = pt.sample_beta(cfg, params, torch.Generator(card).manual_seed(0))
    z0 = torch.tensor(INITIAL_GUESS, dtype=cfg.torch_dtype, device=card)
    Z = torch.cat([z0[None], z0[None] + 1e-2 * torch.eye(
        3, dtype=cfg.torch_dtype, device=card)])[:n_points]
    v0, s0 = pt.lift(cfg, params, pt.z_to_u(Z))
    return cfg, params, beta, Z, v0, s0, pt.initial_spike_indices(cfg, Z)


def residual(cfg, Z, res):
    P = Z.shape[0]
    pos = pt.restrict_positions(cfg, res).reshape(P, -1, cfg.n_spikes)
    mean, _ = pt.masked_ensemble_mean(pos, res.accept.reshape(P, -1))
    return assemble_residual(cfg, pt.z_to_u(Z), mean)


@pytest.mark.parametrize("dtype, n_neurons, n_real, identical, dtime, dres", [
    ("float64", 512, 16, 0.99, 1e-9, 1e-8),
    ("float32", 512, 16, 0.95, None, 2e-5),
    # N not a multiple of the block's 256 threads
    ("float64", 300, 4, 0.99, 1e-9, 1e-8),
])
def test_kernel_matches_plain_evolve(card, dtype, n_neurons, n_real,
                                     identical, dtime, dres):
    """The targets chip_smoke.py holds the kernel to."""
    cfg, _, beta, Z, v0, s0, init_ind = inputs(card, n_neurons, n_real, dtype)
    before = evolve_cuda.LAUNCHES
    rk = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, init_ind)
    torch.cuda.synchronize()
    assert evolve_cuda.LAUNCHES == before + 1
    rp = pt.evolve_ensemble(cfg, v0, s0, beta, init_ind)
    same = ((rk.last_ind == rp.last_ind).all(1)
            & (rk.crossed_ind == rp.crossed_ind).all(1)
            & (rk.accept == rp.accept) & (rk.n_events == rp.n_events))
    assert float(same.float().mean()) >= identical
    if dtime is not None:
        for a, b in ((rk.last_time, rp.last_time),
                     (rk.crossed_time, rp.crossed_time)):
            assert float((a - b)[same].abs().max()) <= dtime
    fk = residual(cfg, Z, rk)
    assert bool(torch.isfinite(fk).all())
    assert float((fk - residual(cfg, Z, rp)).abs().max()) <= dres


def test_kernel_above_48kb_of_shared_memory(card):
    """N=4096 in f64 keeps 96 KB of row state in shared memory, which needs
    the opt-in launch attribute; one row against the plain evolve."""
    cfg, _, beta, Z, v0, s0, init_ind = inputs(card, 4096, 1, "float64",
                                               n_points=1)
    rk = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, init_ind)
    rp = pt.evolve_ensemble(cfg, v0, s0, beta, init_ind)
    assert torch.equal(rk.n_events, rp.n_events)
    assert torch.equal(rk.crossed_ind, rp.crossed_ind)
    assert float((rk.crossed_time - rp.crossed_time).abs().max()) <= 1e-9


def test_map_on_card_launches_the_kernel_once_per_evaluation(card):
    cfg, params, beta, Z, *_ = inputs(card, 512, 8, "float32")
    F = pt.make_residual_fn(cfg, params, 0, device=card, beta=beta)
    Fp = pt.make_residual_fn(cfg, params, 0, device=card, beta=beta,
                             evolve_backend="torch")
    before = evolve_cuda.LAUNCHES
    f_one, f_stack = F(Z[0]), F(Z)
    assert evolve_cuda.LAUNCHES == before + 2
    assert f_stack.shape == Z.shape and f_one.shape == (3,)
    assert float((f_stack - Fp(Z)).abs().max()) <= 2e-5
    assert evolve_cuda.LAUNCHES == before + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    cfg, _, beta, _, v0, s0, init_ind = inputs(card, 512, 4, "float32")
    with pytest.raises(ValueError, match="contiguous"):
        evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta.T.contiguous().T,
                                         init_ind)
    with pytest.raises(TypeError):
        evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta.double(),
                                         init_ind)
    with pytest.raises(ValueError):
        evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta,
                                         init_ind.cpu())
