"""The evolve kernel with the certified window, and the evolve and replay
kernels at N above what one CTA's shared memory holds, on the card: the
windowed kernel against the same kernel on every lane and against the plain
windowed evolve, the large-N kernels against their plain versions, all on
the same CUDA tensors.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_evolve_window_cuda.py -m cuda
"""

import pytest
import torch

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.emap import (
    assemble_residual)
from armadillocudalinearinterpolation_torch.model.evolve_batched import (
    evolve_ensemble_batched)
from log_certificate import log_form_fallbacks

pytestmark = pytest.mark.cuda

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)
FIELDS = ("last_ind", "last_time", "crossed_ind", "crossed_time", "accept",
          "n_events")
# kernel vs plain: the bars chip_smoke.py holds the evolve kernel to
TARGETS = {"float64": (0.99, 1e-9, 1e-8), "float32": (0.95, None, 2e-5)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def inputs(card, n_neurons, n_real, dtype, window=0, n_points=4,
           max_events=4096):
    """The lifts of the Driver.cu guess and its forward-FD perturbations at
    eps 1e-2, and a seeded draw at sigma 0.1, on the card."""
    cfg = pt.ModelConfig(n_neurons=n_neurons, n_real=n_real, dtype=dtype,
                         evolve_window=window, max_events=max_events)
    params = pt.MapParams.create(13.0589, 0.1, dtype=dtype, device=card)
    beta = pt.sample_beta(cfg, params, torch.Generator(card).manual_seed(0))
    z0 = torch.tensor(INITIAL_GUESS, dtype=cfg.torch_dtype, device=card)
    Z = torch.cat([z0[None], z0[None] + 1e-2 * torch.eye(
        3, dtype=cfg.torch_dtype, device=card)])[:n_points]
    v0, s0 = pt.lift(cfg, params, pt.z_to_u(Z))
    return (cfg, beta, Z, v0.contiguous(), s0.contiguous(),
            pt.initial_spike_indices(cfg, Z).contiguous())


def assert_equal_results(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def residual(cfg, Z, res):
    P = Z.shape[0]
    pos = pt.restrict_positions(cfg, res).reshape(P, -1, cfg.n_spikes)
    mean, _ = pt.masked_ensemble_mean(pos, res.accept.reshape(P, -1))
    return assemble_residual(cfg, pt.z_to_u(Z), mean)


def assert_kernel_near_plain(cfg, Z, rk, rp):
    identical, dtime, dres = TARGETS[cfg.dtype]
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
    return same


@pytest.mark.parametrize("record", [0, 1024])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_windowed_kernel_is_the_full_kernel_and_near_plain(card, dtype,
                                                          record):
    """W=128 at N=512: every row and log entry equal to the kernel on every
    lane, and the plain windowed evolve's outcome at the kernel's bars."""
    cfg, beta, Z, v0, s0, ii = inputs(card, 512, 16, dtype, window=128)
    rows = Z.shape[0] * cfg.n_real
    fb = torch.zeros(rows, dtype=torch.int32, device=card)
    before = evolve_cuda.LAUNCHES
    rw = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii,
                                          record_schedule=record,
                                          fallbacks=fb)
    rf = evolve_cuda.evolve_ensemble_cuda(cfg.with_(evolve_window=0), v0, s0,
                                          beta, ii, record_schedule=record)
    rp = evolve_ensemble_batched(cfg, v0, s0, beta, ii,
                                 record_schedule=record)
    torch.cuda.synchronize()
    assert evolve_cuda.LAUNCHES == before + 2
    if record:
        (rw, sw), (rf, sf), (rp, sp) = rw, rf, rp
        assert torch.equal(sw, sf)
    assert_equal_results(rw, rf)
    same = assert_kernel_near_plain(cfg, Z, rw, rp)
    if record:
        assert torch.equal(sw[same], sp[same])
    # the window held for most events, and in f64, in the rows where the
    # plain evolve took the kernel's events, on the same events as under
    # the per-lane log form of the certificate
    assert int(fb.sum()) < int(rw.n_events.sum()) // 10
    if dtype == "float64":
        log_fb = log_form_fallbacks(cfg, v0, s0, beta, ii)
        assert torch.equal(fb[same], log_fb[same])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_forced_fallback_stays_exact_on_the_card(card, dtype):
    """Spikes spread far beyond one 128-lane window (the case of
    tests/test_evolve_batched.py:58-90): every row falls back, and the
    results still equal the kernel on every lane; the plain windowed
    evolve, and in f64 the JAX package's per-lane log form of the
    certificate on the kernel's states, count the same fallbacks."""
    cfg = pt.ModelConfig(n_neurons=512, n_real=4, dtype=dtype,
                         evolve_window=128)
    params = pt.MapParams.create(13.0589, 0.0, dtype=dtype, device=card)
    U = torch.tensor([[0.3262, 0.0, 0.7194, 1.3690]], dtype=cfg.torch_dtype,
                     device=card)
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params, U))
    g = torch.Generator(card).manual_seed(7)
    beta = (13.0589 + 0.1 * torch.randn(4, 512, generator=g, device=card,
                                        dtype=cfg.torch_dtype)).contiguous()
    ii = torch.tensor([[420, 256, 60]], dtype=torch.int32, device=card)
    fb = torch.zeros(4, dtype=torch.int32, device=card)
    fb_plain = torch.zeros(4, dtype=torch.int32, device=card)
    rw = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii,
                                          fallbacks=fb)
    rf = evolve_cuda.evolve_ensemble_cuda(cfg.with_(evolve_window=0), v0, s0,
                                          beta, ii)
    rp = evolve_ensemble_batched(cfg, v0, s0, beta, ii, fallbacks=fb_plain)
    assert_equal_results(rw, rf)
    assert int(fb.min()) > 0 and bool((fb <= rw.n_events).all())
    assert int(fb_plain.min()) > 0
    if dtype == "float64":
        assert_equal_results(rp, rw)
        assert torch.equal(fb, fb_plain)
        assert torch.equal(fb, log_form_fallbacks(cfg, v0, s0, beta, ii))


def test_evolve_kernel_above_its_shared_memory_n(card):
    """f64 at N=10240 keeps more row state than one CTA's shared memory:
    the kernel keeps it in device memory, on every lane and windowed, and
    matches the plain evolve."""
    cfg, beta, Z, v0, s0, ii = inputs(card, 10240, 2, "float64", n_points=1,
                                      max_events=16384)
    assert not evolve_cuda.row_fits_shared(
        10240, cfg.n_spikes, torch.float64, "evolve",
        evolve_cuda.shared_optin_bytes(card))
    rk = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii)
    rw = evolve_cuda.evolve_ensemble_cuda(cfg.with_(evolve_window=512), v0,
                                          s0, beta, ii)
    rp = pt.evolve_ensemble(cfg, v0, s0, beta, ii)
    assert_equal_results(rw, rk)
    assert torch.equal(rk.n_events, rp.n_events)
    assert torch.equal(rk.crossed_ind, rp.crossed_ind)
    assert torch.equal(rk.last_ind, rp.last_ind)
    for a, b in ((rk.last_time, rp.last_time),
                 (rk.crossed_time, rp.crossed_time)):
        assert float((a - b).abs().max()) <= 1e-9
    assert bool(rk.accept.all())


def test_replay_kernel_above_its_shared_memory_n(card):
    """N=8448 keeps more fp64 row state and kick table than one CTA's
    shared memory: K2 keeps the row in device memory and matches the plain
    replay on K1's f32 log."""
    cfg, beta, _, v0, s0, ii = inputs(card, 8448, 2, "float64", n_points=1,
                                      max_events=16384)
    cfg = cfg.with_(root_tol=1e-12)
    assert not evolve_cuda.row_fits_shared(
        8448, cfg.n_spikes, torch.float64, "replay",
        evolve_cuda.shared_optin_bytes(card))
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    before = replay_cuda.LAUNCHES
    rk = pt.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, ii[0])
    torch.cuda.synchronize()
    assert replay_cuda.LAUNCHES == before + 1
    rp = pt.replay_events(cfg, sched, n_ev, v0, s0, beta, ii[0])
    for name in ("last_ind", "crossed_ind", "accept", "n_events"):
        assert torch.equal(getattr(rk, name), getattr(rp, name)), name
    for name in ("last_time", "crossed_time"):
        d = (getattr(rk, name) - getattr(rp, name)).abs().max()
        assert float(d) <= 1e-12, name
    assert bool(rk.accept.all())
