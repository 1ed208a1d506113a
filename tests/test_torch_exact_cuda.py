"""The tangent replay kernel (K2T) and the per-row rates of the evolve
and replay kernels (K1, K2) on the card, against their plain PyTorch
versions on the same CUDA tensors.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_exact_cuda.py -m cuda
"""

import pytest
import torch

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.emap import (
    beta_from_noise, sample_noise)
from armadillocudalinearinterpolation_torch.model.evolve_batched import (
    evolve_ensemble_batched)
from armadillocudalinearinterpolation_torch.model.replay import (
    replay_events, replay_events_tangent)

pytestmark = pytest.mark.cuda

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)
# K2T vs plain: the same fp64 formulas in the same order, no FMA; relative
# to the tangent's size
TANGENT_BAR = 1e-12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def tangent_inputs(dev, N, R, P=2, max_events=2048, per_row=True):
    """Lifts of P points around the Driver.cu guess at their own beta
    (13.0589 + 0.01 p, sigma 0.1), their (P * R, N) rates (or the shared
    (R, N) ones), the f32 discovery log of each row and D = 4 directions:
    two Z seeds, the beta axis and the sigma axis (the noise)."""
    cfg = pt.ModelConfig(n_neurons=N, n_real=R, dtype="float64",
                         root_tol=1e-12, max_events=max_events)
    noise = sample_noise(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    f64 = torch.float64
    mean = 13.0589 + 0.01 * torch.arange(P, dtype=f64, device=dev)
    params = pt.MapParams(beta=mean if per_row else mean[:1],
                          sigma=torch.full_like(mean, 0.1)
                          if per_row else torch.tensor(0.1, dtype=f64,
                                                       device=dev))
    beta = beta_from_noise(cfg, params, noise).contiguous()
    if not per_row:
        params = pt.MapParams(beta=mean[0], sigma=params.sigma)
    z0 = torch.tensor(INITIAL_GUESS, dtype=f64, device=dev)
    Z = z0[None] + 1e-3 * torch.arange(P, dtype=f64, device=dev)[:, None]
    v0, s0 = pt.lift(cfg, pt.MapParams(beta=mean[:, None], sigma=0.1),
                     pt.z_to_u(Z))
    ii = pt.initial_spike_indices(cfg, Z).contiguous()
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii, n_real=R)
    gen = torch.Generator(dev).manual_seed(1)
    dv = torch.zeros(4, P, N, dtype=f64, device=dev)
    ds = torch.zeros_like(dv)
    dv[:2] = 1e-2 * torch.randn(2, P, N, generator=gen, dtype=f64,
                                device=dev)
    ds[:2] = 1e-2 * torch.randn(2, P, N, generator=gen, dtype=f64,
                                device=dev)
    rows = beta.shape[0]
    db = torch.zeros(4, rows, N, dtype=f64, device=dev)
    db[2] = 1.0
    db[3] = noise.repeat(rows // R, 1)
    return (cfg, sched.contiguous(), n_ev.contiguous(), v0.contiguous(),
            s0.contiguous(), beta, ii, dv, ds, db.contiguous(), R)


def assert_tangents_match(got, want):
    res_g, dl_g, dc_g = got
    res_w, dl_w, dc_w = want
    for name in res_w._fields:
        torch.testing.assert_close(getattr(res_g, name),
                                   getattr(res_w, name), rtol=0, atol=0,
                                   equal_nan=True, msg=name)
    for g, w in ((dl_g, dl_w), (dc_g, dc_w)):
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TANGENT_BAR * scale


@pytest.mark.parametrize("threads", [None, 64, 160, 512])
def test_k2t_matches_plain_at_block_sizes(card, monkeypatch, threads):
    """K2T against the plain tangent replay: primal equal at 0.0, tangents
    within 1e-12 relative, with per-row rates and all four kinds of
    direction, at the layout's block size and forced ones."""
    if threads is not None:
        monkeypatch.setattr(replay_cuda, "replay_layout",
                            lambda *_: threads)
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db,
     R) = tangent_inputs(card, 512, 8)
    launches = replay_cuda.TANGENT_LAUNCHES
    got = replay_cuda.replay_events_tangent_cuda(
        cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db, n_real=R)
    assert replay_cuda.TANGENT_LAUNCHES == launches + 1
    want = replay_events_tangent(cfg, sched, n_ev, v0, s0, beta, ii, dv, ds,
                                 db, n_real=R)
    assert bool(got[0].accept.any())
    assert_tangents_match(got, want)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row",
                                                        "shared"])
def test_k2t_primal_equals_k2(card, per_row):
    """K2T's primal outputs are K2's bit for bit (the same per-lane
    code), with per-row and with shared rates."""
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db,
     R) = tangent_inputs(card, 1024, 16, per_row=per_row)
    if not per_row:
        db = db[:, :R].contiguous()
    res_t, _, _ = replay_cuda.replay_events_tangent_cuda(
        cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db, n_real=R)
    res = replay_cuda.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, ii,
                                         n_real=R)
    for name in res._fields:
        assert torch.equal(getattr(res_t, name), getattr(res, name)), name


def test_k2t_rows_in_device_memory(card):
    """N = 8448: the row does not fit one CTA's shared memory and runs in
    the device-memory variant; still equal to the plain tangent replay."""
    N = 8448
    assert not evolve_cuda.row_fits_shared(N, 3, torch.float64, "tangent",
                                           evolve_cuda.shared_optin_bytes(
                                               card))
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db,
     R) = tangent_inputs(card, N, 1, P=1, max_events=16384)
    got = replay_cuda.replay_events_tangent_cuda(
        cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db, n_real=R)
    want = replay_events_tangent(cfg, sched, n_ev, v0, s0, beta, ii, dv, ds,
                                 db, n_real=R)
    assert_tangents_match(got, want)


def test_k2t_refuses_cpu_tensors():
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db,
     R) = tangent_inputs(torch.device("cpu"), 256, 2)
    with pytest.raises(ValueError, match="CUDA"):
        replay_cuda.replay_events_tangent_cuda(
            cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, db, n_real=R)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_and_k2_per_row_rates(card, dtype):
    """K1 and K2 with (P * R, N) rates equal their plain versions with the
    same rates (K1: indices exact, times to 1e-10 as the window tests
    hold them; K2: every field at 0.0)."""
    (cfg, sched, n_ev, v0, s0, beta, ii, *_rest) = tangent_inputs(
        card, 512, 8, P=3)
    R = cfg.n_real
    t = cfg.with_(dtype=dtype).torch_dtype
    c = cfg.with_(dtype=dtype)
    v, s, b = (x.to(t).contiguous() for x in (v0, s0, beta))
    k1 = evolve_cuda.evolve_ensemble_cuda(c, v, s, b, ii, n_real=R)
    p1 = evolve_ensemble_batched(c, v, s, b, ii, n_real=R)
    for name in ("last_ind", "crossed_ind", "accept", "n_events"):
        assert torch.equal(getattr(k1, name), getattr(p1, name)), name
    for name in ("last_time", "crossed_time"):
        d = (getattr(k1, name) - getattr(p1, name)).abs().max()
        assert float(d) <= (1e-10 if dtype == "float64" else 1e-4), name
    k2 = replay_cuda.replay_events_cuda(c, sched, n_ev, v, s, b, ii,
                                        n_real=R)
    p2 = replay_events(c, sched, n_ev, v, s, b, ii, n_real=R)
    for name in p2._fields:
        torch.testing.assert_close(getattr(k2, name), getattr(p2, name),
                                   rtol=0, atol=0, equal_nan=True, msg=name)
