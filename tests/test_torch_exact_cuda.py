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


def tangent_inputs(dev, N, R, P=2, max_events=2048, per_row=True, D=4,
                   param="sigma"):
    """Lifts of P points around the Driver.cu guess at their own beta
    (13.0589 + 0.01 p, sigma 0.1), their (P * R, N) rates (or the shared
    (R, N) ones), the f32 discovery log of each row and D <= 4 directions:
    random lift tangents on the first two, and on every one a random
    parameter tangent at each point, along the sigma axis (the noise as the
    rates' base) or the beta axis (ones)."""
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
    z0 = torch.tensor(INITIAL_GUESS, dtype=f64, device=dev)
    Z = z0[None] + 1e-3 * torch.arange(P, dtype=f64, device=dev)[:, None]
    v0, s0 = pt.lift(cfg, pt.MapParams(beta=mean[:, None], sigma=0.1),
                     pt.z_to_u(Z))
    ii = pt.initial_spike_indices(cfg, Z).contiguous()
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii, n_real=R)
    gen = torch.Generator(dev).manual_seed(1)
    dv = torch.zeros(D, P, N, dtype=f64, device=dev)
    ds = torch.zeros_like(dv)
    dv[:2] = 1e-2 * torch.randn(min(D, 2), P, N, generator=gen, dtype=f64,
                                device=dev)
    ds[:2] = 1e-2 * torch.randn(min(D, 2), P, N, generator=gen, dtype=f64,
                                device=dev)
    dp = torch.randn(D, P, generator=gen, dtype=f64, device=dev)
    base = (noise.to(f64) if param == "sigma"
            else torch.ones(R, N, dtype=f64, device=dev)).contiguous()
    return (cfg, sched.contiguous(), n_ev.contiguous(), v0.contiguous(),
            s0.contiguous(), beta, ii, dv, ds, base, dp, R)


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


def k2t_against_plain(case, times=None):
    """K2T and the plain tangent replay on ``case``, with one launch
    counted."""
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp, R) = case
    launches = replay_cuda.TANGENT_LAUNCHES
    got = replay_cuda.replay_events_tangent_cuda(
        cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp, n_real=R,
        times=times)
    assert replay_cuda.TANGENT_LAUNCHES == launches + 1
    want = replay_events_tangent(cfg, sched, n_ev, v0, s0, beta, ii, dv, ds,
                                 base, dp, n_real=R, times=times)
    assert bool(got[0].accept.any())
    assert_tangents_match(got, want)
    return got


def force_layout(monkeypatch, cluster, threads=None, in_shared=True):
    """Replace the layout function: every K2T launch takes this cluster
    (and block size, or the layout's own at that cluster)."""
    layout = replay_cuda.replay_layout

    def forced(N, M, rows, sms, optin, per_sm, kind="replay", D=1):
        own = layout(N, M, rows, sms, optin, per_sm, kind, D)
        if kind != "tangent":
            return own
        return replay_cuda.TangentLayout(cluster, threads or own.threads,
                                         in_shared)
    monkeypatch.setattr(replay_cuda, "replay_layout", forced)


@pytest.mark.parametrize("threads", [None, 64, 160, 512])
def test_k2t_matches_plain_at_block_sizes(card, monkeypatch, threads):
    """K2T against the plain tangent replay: primal equal at 0.0, tangents
    within 1e-12 relative, with per-row rates and D = 4 directions, at the
    layout's block size and forced ones (one CTA a row at N=512)."""
    if threads is not None:
        force_layout(monkeypatch, 1, threads)
    k2t_against_plain(tangent_inputs(card, 512, 8))


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("cluster", replay_cuda.CLUSTER_SIZES)
def test_k2t_matches_plain_at_every_cluster(card, monkeypatch, cluster, D):
    """Every cluster size the layout can take, forced at N=1000 (a ragged
    last CTA), D = 1 to 4 directions along the beta axis, per-row rates:
    K2T equals the plain version (primal 0.0, tangents 1e-12)."""
    force_layout(monkeypatch, cluster)
    k2t_against_plain(tangent_inputs(card, 1000, 4, D=D, param="beta"))


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row",
                                                        "shared"])
def test_k2t_primal_equals_k2(card, per_row):
    """In root-find mode K2T's primal outputs are K2's bit for bit (the
    same per-lane code), with per-row and with shared rates, at the
    layout's cluster (N=4096: two CTAs a row)."""
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp,
     R) = tangent_inputs(card, 4096, 8, per_row=per_row)
    res_t, _, _ = replay_cuda.replay_events_tangent_cuda(
        cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp, n_real=R)
    res = replay_cuda.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, ii,
                                         n_real=R)
    for name in res._fields:
        assert torch.equal(getattr(res_t, name), getattr(res, name)), name


@pytest.mark.parametrize("N", [512, 4096])
def test_k2t_with_time_log_matches_plain(card, N):
    """K1 f64 with its firing order and time log, then K2T with that log
    against the plain tangent replay with it: tangents 1e-12 relative,
    and the primal times K1's own bit for bit (the replay adds the
    logged dt as K1 added it)."""
    (cfg, _, _, v0, s0, beta, ii, dv, ds, base, dp,
     R) = tangent_inputs(card, N, 8, D=3)
    rows, E = beta.shape[0], 4096
    times = torch.empty(rows, E, dtype=torch.float64, device=card)
    res, sched = evolve_cuda.evolve_ensemble_cuda(
        cfg.with_(root_tol=1e-6), v0, s0, beta, ii, record_schedule=E,
        n_real=R, event_times=times)
    assert int(res.n_events.max()) <= E
    got = k2t_against_plain((cfg.with_(root_tol=1e-6), sched, res.n_events,
                             v0, s0, beta, ii, dv, ds, base, dp, R),
                            times=times)
    for name in ("last_time", "crossed_time", "last_ind", "crossed_ind",
                 "accept"):
        assert torch.equal(getattr(got[0], name), getattr(res, name)), name


def test_k1_time_log_matches_the_plain_evolve(card):
    """K1 f64's time log against the plain evolve's on the same inputs:
    the same firing order, the times to 1e-10 (the evolve's own bar)."""
    (cfg, _, _, v0, s0, beta, ii, *_rest, R) = tangent_inputs(card, 512, 8)
    rows, E = beta.shape[0], 2048
    logs = []
    for evolve in (evolve_cuda.evolve_ensemble_cuda, evolve_ensemble_batched):
        times = torch.empty(rows, E, dtype=torch.float64, device=card)
        res, sched = evolve(cfg, v0, s0, beta, ii, record_schedule=E,
                            n_real=R, event_times=times)
        logs.append((res.n_events, sched, times))
    (n_k, s_k, t_k), (n_p, s_p, t_p) = logs
    assert torch.equal(n_k, n_p) and torch.equal(s_k, s_p)
    assert float((t_k - t_p).abs().max()) <= 1e-10
    assert bool((t_k[:, 0] > 0).all())


def test_k2t_rows_in_device_memory(card, monkeypatch):
    """N = 8448, where the layout splits a row over 8 CTAs, and the same
    row forced into the device-memory variant (one CTA a row): both equal
    to the plain tangent replay."""
    N = 8448
    case = tangent_inputs(card, N, 1, P=1, max_events=16384)
    props = torch.cuda.get_device_properties(card)
    layout = replay_cuda.replay_layout(
        N, 3, 1, props.multi_processor_count,
        evolve_cuda.shared_optin_bytes(card),
        props.shared_memory_per_multiprocessor, "tangent", 4)
    assert layout.cluster == 8 and layout.in_shared
    want = k2t_against_plain(case)
    force_layout(monkeypatch, 1, in_shared=False)
    got = k2t_against_plain(case)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def test_k2t_shared_bytes_match_the_kernel(card):
    """The layout's count of a K2T CTA's shared memory is the kernel's
    (``tangent_smem_bytes``) for every cluster size and D = 1 to 6, in
    shared and device memory."""
    from armadillocudalinearinterpolation_torch import _build
    lib = _build.load_library()
    for N in (512, 1000, 4096, 8448):
        for C in replay_cuda.CLUSTER_SIZES:
            for D in range(1, 7):
                for in_shared in (True, False):
                    assert lib.atorch_replay_tangent_smem_bytes(
                        N, 3, D, C, int(not in_shared)) == \
                        replay_cuda.tangent_shared_bytes(N, 3, D, C,
                                                         in_shared)


def test_k2t_refuses_a_layout_that_does_not_fit(card, monkeypatch):
    """No fallback: a cluster too small for the row's shared memory, a
    cluster size the kernel does not take, or the device-memory variant
    in a cluster: the launch is refused and the wrapper raises."""
    case = tangent_inputs(card, 4096, 2)
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp, R) = case
    for cluster, in_shared in ((1, True), (3, True), (16, True),
                               (2, False)):
        force_layout(monkeypatch, cluster, in_shared=in_shared)
        with pytest.raises(RuntimeError, match="tangent replay kernel"):
            replay_cuda.replay_events_tangent_cuda(
                cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp,
                n_real=R)


def test_k2t_refuses_cpu_tensors():
    (cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp,
     R) = tangent_inputs(torch.device("cpu"), 256, 2)
    with pytest.raises(ValueError, match="CUDA"):
        replay_cuda.replay_events_tangent_cuda(
            cfg, sched, n_ev, v0, s0, beta, ii, dv, ds, base, dp, n_real=R)


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
