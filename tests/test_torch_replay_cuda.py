"""The evolve kernel's firing-order log and the replay kernel (K2) on the
card, against their plain PyTorch versions on the same CUDA tensors.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_replay_cuda.py -m cuda
"""

import pytest
import torch

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch import _build
from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.replay import (
    schedule_config)

pytestmark = pytest.mark.cuda

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)
TIME_BAR = 1e-12          # K2 vs plain: the same fp64 formulas, no FMA


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def inputs(card, n_neurons, n_real, dtype="float64", n_points=1,
           max_events=2048):
    """The lifts of the Driver.cu guess and its forward-FD perturbations at
    eps 1e-5, and a seeded draw at sigma 0.1, on the card."""
    cfg = pt.ModelConfig(n_neurons=n_neurons, n_real=n_real, dtype=dtype,
                         root_tol=1e-12, max_events=max_events)
    params = pt.MapParams.create(13.0589, 0.1, dtype=dtype, device=card)
    beta = pt.sample_beta(cfg, params, torch.Generator(card).manual_seed(0))
    z0 = torch.tensor(INITIAL_GUESS, dtype=cfg.torch_dtype, device=card)
    Z = torch.cat([z0[None], z0[None] + 1e-5 * torch.eye(
        3, dtype=cfg.torch_dtype, device=card)])[:n_points]
    v0, s0 = pt.lift(cfg, params, pt.z_to_u(Z))
    return (cfg, params, beta, Z, v0.contiguous(), s0.contiguous(),
            pt.initial_spike_indices(cfg, Z).contiguous())


def same_outcome(a, b):
    return ((a.last_ind == b.last_ind).all(1)
            & (a.crossed_ind == b.crossed_ind).all(1)
            & (a.accept == b.accept) & (a.n_events == b.n_events))


def assert_replays_equal(got, want):
    for name in ("last_ind", "crossed_ind", "accept", "n_events"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("last_time", "crossed_time"):
        d = (getattr(got, name) - getattr(want, name)).abs().max()
        assert float(d) <= TIME_BAR, name


@pytest.mark.parametrize("E", [2048, 128])
def test_log_kernel_matches_plain_log(card, E):
    """K1 with its log (f32, N=512, R=16, 4 points): the evolve is the
    same as without the log, >= 95% of rows have the plain version's
    discrete outcome (the f32 bar of test_torch_cuda.py), and those rows
    have the same log.  E=128 overflows: n_events keeps counting and the
    log holds the first 128 events."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, 512, 16, "float32", 4)
    before = evolve_cuda.LAUNCHES
    rk, sk = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii,
                                              record_schedule=E)
    torch.cuda.synchronize()
    assert evolve_cuda.LAUNCHES == before + 1
    assert sk.shape == (64, E) and sk.dtype == torch.int32
    for a, b in zip(rk, evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta,
                                                         ii)):
        assert torch.equal(a, b)
    rp, sp = pt.evolve_ensemble(cfg, v0, s0, beta, ii, record_schedule=E)
    same = same_outcome(rk, rp)
    assert float(same.float().mean()) >= 0.95
    assert torch.equal(sk[same], sp[same])
    if E == 128:
        assert int(rk.n_events.min()) > E


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("own_schedules", [False, True])
def test_replay_kernel_matches_plain_replay(card, dtype, own_schedules):
    """K2 vs the plain replay on a 4-point stack (N=512, R=8): one shared
    schedule with shared seeding (the frozen stencil), or each row's own
    schedule with per-point seeding (the replay backend)."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, 512, 8, dtype, 4)
    if own_schedules:
        sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
        init = ii
    else:
        sched, n_ev = pt.compute_schedule(cfg, v0[:1], s0[:1], beta, ii[:1])
        init = ii[0].contiguous()
    before = replay_cuda.LAUNCHES
    rk = pt.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, init)
    torch.cuda.synchronize()
    assert replay_cuda.LAUNCHES == before + 1
    rp = pt.replay_events(cfg, sched, n_ev, v0, s0, beta, init)
    assert rk.last_time.dtype == v0.dtype
    assert_replays_equal(rk, rp)
    assert float(rk.accept.float().mean()) > 0.5


def test_replay_kernel_overflow_and_misfire_rows(card):
    """An overflowed row and a forced misfire are rejected by both versions
    alike, with no NaN anywhere."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, 512, 8)
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    times = pt.event_time(v0[0].float(), s0[0].float(), beta[2].float(),
                          schedule_config(cfg))
    sched[2, 0] = int(torch.nonzero(times >= 100.0)[0, 0])
    n_ev[0] = sched.shape[1] + 5
    rk = pt.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, ii[0])
    rp = pt.replay_events(cfg, sched, n_ev, v0, s0, beta, ii[0])
    assert_replays_equal(rk, rp)
    assert not bool(rk.accept[0]) and not bool(rk.accept[2])
    assert bool(rk.accept[1])
    for x in rk:
        assert bool(torch.isfinite(x.double()).all())


def test_replay_kernel_at_4096_lanes(card):
    """N=4096 keeps 112 KB of row state and kick table in shared memory,
    which needs the opt-in launch attribute; the kernel still matches the
    plain version, and replaying the direct f64 evolve's own firing order
    reproduces it to 1e-10 (the f32 discovery order can swap
    near-simultaneous firings, a neighbouring smooth piece of the map)."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, 4096, 2, max_events=4096)
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    rk = pt.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, ii[0])
    assert_replays_equal(rk, pt.replay_events(cfg, sched, n_ev, v0, s0,
                                              beta, ii[0]))
    direct, sched64 = evolve_cuda.evolve_ensemble_cuda(
        cfg, v0, s0, beta, ii, record_schedule=sched.shape[1])
    r64 = pt.replay_events_cuda(cfg, sched64, direct.n_events, v0, s0, beta,
                                ii[0])
    assert bool(same_outcome(r64, direct).all())
    for a, b in ((r64.last_time, direct.last_time),
                 (r64.crossed_time, direct.crossed_time)):
        assert float((a - b).abs().max()) <= 1e-10


def test_replay_map_launches_each_kernel_once_per_evaluation(card):
    cfg, params, beta, Z, *_ = inputs(card, 512, 8, n_points=4)
    k1, k2 = evolve_cuda.LAUNCHES, replay_cuda.LAUNCHES
    f = pt.event_driven_map(cfg, params, beta, Z, evolve_backend="replay")
    assert (evolve_cuda.LAUNCHES - k1, replay_cuda.LAUNCHES - k2) == (1, 1)
    assert f.shape == Z.shape and bool(torch.isfinite(f).all())
    outcome = pt.compute_discrete_outcome(cfg, params, beta, Z[0])
    assert (evolve_cuda.LAUNCHES - k1, replay_cuda.LAUNCHES - k2) == (2, 1)
    g = pt.frozen_schedule_map_batched(cfg, params, beta, Z, *outcome)
    assert (evolve_cuda.LAUNCHES - k1, replay_cuda.LAUNCHES - k2) == (2, 2)
    assert torch.equal(g[0], f[0])


# ------------------------------------------------------- forced layouts
# the block sizes K2 is forced into by replacing replay_layout: the event
# warp and one sweep warp, a count of warps that does not divide the lanes,
# and the most K2 takes
FORCED = [64, 160, 512]


@pytest.fixture
def force_layout(monkeypatch):
    def force(threads):
        monkeypatch.setattr(replay_cuda, "replay_layout", lambda *_: threads)
    return force


def assert_identical(got, want):
    """K2 equals the plain replay exactly: every field, times 0.0 apart
    (NaN where the plain replay has NaN: edited logs polish some rows'
    residuals into NaN, in both versions alike)."""
    for name in want._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=name)


@pytest.fixture(scope="module")
def config4_like():
    """Config-4 lifts (N=4096, R=64, f64): the guess (64 rows) and its
    forward stencil (256 rows) on the guess's log, with the plain
    replay's results (7-12 s a call on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg, _, beta, _, v0, s0, ii = inputs(torch.device("cuda"), 4096, 64,
                                         n_points=4, max_events=4096)
    sched, n_ev = pt.compute_schedule(cfg, v0[:1], s0[:1], beta, ii[:1])
    cases = {}
    for P in (1, 4):
        args = (cfg, sched, n_ev, v0[:P].contiguous(), s0[:P].contiguous(),
                beta, ii[0].contiguous())
        cases[64 * P] = args, pt.replay_events(*args)
    return cases


@pytest.mark.parametrize("layout", FORCED)
@pytest.mark.parametrize("rows", [64, 256])
def test_every_layout_equals_plain_at_config4_shapes(config4_like,
                                                     force_layout, rows,
                                                     layout):
    args, want = config4_like[rows]
    force_layout(layout)
    before = replay_cuda.LAUNCHES
    assert_identical(pt.replay_events_cuda(*args), want)
    assert replay_cuda.LAUNCHES == before + 1
    assert float(want.accept.float().mean()) > 0.5


def hand_made(card, N):
    """N=512, R=8, each row its own edited log: a lane repeated on three
    consecutive events (row 0), neighbouring lanes alternating in the
    middle of the row (row 1) and at its ring seam, lanes N - 1 and 0 (row
    2), a lane out of range in mid-log (rows 3 and 4), an overflowed row
    (5), a log cut short (6); row 7 keeps its log and stops on
    all-crossed."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, N, 8, max_events=1024)
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    sched[0, 10:13] = sched[0, 9]
    for e in range(20, 60):
        sched[1, e] = N // 2 - 1 + e % 2
        sched[2, e] = (N - 1 + e % 2) % N
    sched[3, 50] = N
    sched[4, 70] = -1
    n_ev[5] = sched.shape[1] + 5
    n_ev[6] = 30
    return cfg, sched, n_ev, v0, s0, beta, ii[0].contiguous()


@pytest.mark.parametrize("layout", FORCED + [None])
def test_every_layout_equals_plain_on_hand_made_logs(card, force_layout,
                                                     layout):
    args = hand_made(card, 512)
    if layout is not None:
        force_layout(layout)
    got = pt.replay_events_cuda(*args)
    want = pt.replay_events(*args)
    assert_identical(got, want)
    assert not any(bool(got.accept[r]) for r in (3, 4, 5, 6))
    assert bool(got.accept[7])


@pytest.mark.parametrize("N", [40, 4095])
def test_every_layout_equals_plain_at_small_and_odd_widths(card,
                                                           force_layout, N):
    """N=40 (fewer lanes than most block sizes' sweep threads: a seeded
    log of random lanes, misfires mostly) and N=4095 (lanes not a multiple
    of any block size), own logs; every forced layout against one plain
    replay."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, N, 8, n_points=2,
                                         max_events=4096)
    if N == 40:
        gen = torch.Generator().manual_seed(4)
        sched = torch.randint(0, N, (16, 256), generator=gen,
                              dtype=torch.int32).to(card)
        n_ev = torch.full((16,), 256, dtype=torch.int32, device=card)
    else:
        sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    args = (cfg, sched, n_ev, v0, s0, beta, ii)
    want = pt.replay_events(*args)
    for layout in FORCED:
        force_layout(layout)
        assert_identical(pt.replay_events_cuda(*args), want)


def test_device_memory_rows_at_two_block_sizes(card, force_layout,
                                               monkeypatch):
    """N=8448 (a row does not fit one CTA's shared memory): the row in
    device memory at two block sizes, and a config-4-wide row (N=4096)
    forced into device memory."""
    cfg, _, beta, _, v0, s0, ii = inputs(card, 8448, 2, max_events=2 * 8448)
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    args = (cfg, sched, n_ev, v0, s0, beta, ii[0].contiguous())
    want = pt.replay_events(*args)
    assert not evolve_cuda.row_fits_shared(
        8448, cfg.n_spikes, torch.float64, "replay",
        evolve_cuda.shared_optin_bytes(card))
    for layout in (160, 512):
        force_layout(layout)
        assert_identical(pt.replay_events_cuda(*args), want)
    args = hand_made(card, 512)
    want = pt.replay_events(*args)
    monkeypatch.setattr(replay_cuda, "row_fits_shared", lambda *a: False)
    assert_identical(pt.replay_events_cuda(*args), want)


def test_layout_beyond_the_kernel_is_refused(card, force_layout):
    """More threads than K2's launch bounds, fewer than the event warp and
    one sweep warp, or not whole warps: the wrapper raises, nothing falls
    back."""
    args = hand_made(card, 512)
    for layout in (1024, 32, 100):
        force_layout(layout)
        with pytest.raises(RuntimeError, match="replay kernel launch"):
            pt.replay_events_cuda(*args)


def test_kernel_registers_fit_the_layout(card):
    """Every K2 variant, as the package's flags compile it
    (``tools/kernel_resources.py``), fits 1024 threads an SM (the budget
    of replay_layout) in the register file."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "kernel_resources", root / "tools" / "kernel_resources.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    regs = {name: r for name, r in tool.source_resources(
        _build.CSRC / "replay.cu").items()
        if "replay_kernel<" in name}
    assert len(regs) == 4
    for r in regs.values():
        assert 0 < r["registers"] * replay_cuda.THREADS_PER_SM <= 65_536


def test_default_layout_fills_the_card(card):
    props = torch.cuda.get_device_properties(card)
    sms, per_sm = props.multi_processor_count, \
        props.shared_memory_per_multiprocessor
    optin = evolve_cuda.shared_optin_bytes(card)
    assert replay_cuda.replay_layout(4096, 3, 64, sms, optin, per_sm) == 512
    assert replay_cuda.replay_layout(4096, 3, 256, sms, optin,
                                     per_sm) == 512
    assert replay_cuda.replay_layout(8448, 3, 2, sms, optin, per_sm) == 512


def test_replay_wrapper_rejects_what_the_kernel_does_not_take(card):
    cfg, _, beta, _, v0, s0, ii = inputs(card, 512, 4)
    sched, n_ev = pt.compute_schedule(cfg, v0, s0, beta, ii)
    with pytest.raises(ValueError, match="contiguous"):
        pt.replay_events_cuda(cfg, sched.T.contiguous().T, n_ev, v0, s0,
                              beta, ii[0])
    with pytest.raises(TypeError):
        pt.replay_events_cuda(cfg, sched.long(), n_ev, v0, s0, beta, ii[0])
    with pytest.raises(ValueError, match="one device"):
        pt.replay_events_cuda(cfg, sched, n_ev, v0, s0, beta, ii[0].cpu())
