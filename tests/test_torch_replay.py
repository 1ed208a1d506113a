"""Port parity of the schedule replay: the plain f32 firing-order log
against the JAX Pallas kernel's (interpret mode) and XLA pass's logs, the
plain fp64 replay against the JAX double-float replay and the JAX f64
evolve, its guards (overflow, padding, misfire, f32 inputs), the replay
map and the frozen-schedule maps against the JAX package's, and the K2
wrapper's refusals without a card (the kernel itself is held against the
plain replay in ``test_torch_replay_cuda.py``).

Inputs: N=512, R=8, f64, root_tol 1e-12, max_events 2048, sigma 0.1, the
JAX ``sample_beta`` draw and the JAX lift of the ``Driver.cu`` guess, fed
to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (INITIAL_GUESS, configs, interpreted,  # noqa: F401
                          jax_draw, jx, params, pt, to_numpy, to_torch)
from armadillocudalinearinterpolation_tpu.model import emap as jemap
from armadillocudalinearinterpolation_tpu.model import lift as jlift
from armadillocudalinearinterpolation_tpu.model import replay as jreplay
from armadillocudalinearinterpolation_tpu.model.evolve_batched import (
    evolve_ensemble_batched)
from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.replay import (
    schedule_width)

KEY = jax.random.PRNGKey(0)
Z0 = np.asarray(INITIAL_GUESS)
TIME_ATOL = 1e-10            # tests/test_replay.py:51-52
INT_FIELDS = ("last_ind", "crossed_ind", "accept", "n_events")
TIME_FIELDS = ("last_time", "crossed_time")


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = configs(n_neurons=512, n_real=8, root_tol=1e-12,
                         max_events=2048)
    jp, pp = params(sigma=0.1)
    beta = jax_draw(jcfg, jp)
    z = jnp.asarray(Z0)
    ii = jlift.initial_spike_indices(jcfg, z)
    v0, s0 = jlift.lift(jcfg, jp, jemap.z_to_u(z))
    res64, sched = evolve_ensemble_batched(
        jcfg, None, v0, s0, jnp.asarray(beta), ii,
        record_schedule=jcfg.max_events)
    rep = jreplay.replay_events(jcfg, sched, res64.n_events, v0, s0,
                                jnp.asarray(beta), ii)
    port_in = {"v0": to_torch(v0)[None], "s0": to_torch(s0)[None],
               "beta": to_torch(beta), "init_ind": to_torch(ii)}
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, pp=pp, beta=beta,
                jax_in=(v0, s0, jnp.asarray(beta), ii), port_in=port_in,
                sched=to_torch(sched), n_sched=to_torch(res64.n_events),
                res64=res64, rep=rep)


def port_replay(setup, sched=None, n_sched=None, cfg=None, **override):
    a = dict(setup["port_in"], **override)
    return pt.replay_events(
        cfg or setup["pcfg"], setup["sched"] if sched is None else sched,
        setup["n_sched"] if n_sched is None else n_sched, a["v0"], a["s0"],
        a["beta"], a["init_ind"])


def assert_same_evolve(got, want, atol=TIME_ATOL, rows=slice(None)):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(got, name))[rows],
                                      np.asarray(getattr(want, name))[rows],
                                      err_msg=name)
    for name in TIME_FIELDS:
        np.testing.assert_allclose(to_numpy(getattr(got, name))[rows],
                                   np.asarray(getattr(want, name))[rows],
                                   rtol=0, atol=atol, err_msg=name)


def test_plain_replay_matches_jax_replay_and_f64_evolve(setup):
    """The JAX schedule replayed by both packages: indices and accept
    identical, times within 1e-10 of the JAX replay and of the JAX f64
    evolve that logged it."""
    rep = port_replay(setup)
    assert rep.last_time.dtype == torch.float64
    assert bool(rep.accept.all())
    assert_same_evolve(rep, setup["rep"])
    assert_same_evolve(rep, setup["res64"])


def test_plain_log_matches_pallas_and_xla_logs(setup, interpreted):
    """The plain f32 evolve with its log against the JAX Pallas kernel's log
    in interpret mode and the JAX XLA f32 pass's, on the same f32 inputs:
    event counts identical, >= 99% of the logged lanes equal (the JAX bar,
    tests/test_replay.py:390-395).  The port's replay accepts the JAX
    kernel's log."""
    jcfg, pcfg = setup["jcfg"], setup["pcfg"]
    v0, s0, beta, ii = setup["jax_in"]
    a = setup["port_in"]
    E = schedule_width(pcfg)
    res32, sched = pt.evolve_ensemble(
        pcfg.with_(dtype="float32", root_tol=1e-6),
        *(a[k].float() for k in ("v0", "s0", "beta")), a["init_ind"][None],
        record_schedule=E)
    n_ev = res32.n_events
    assert sched.shape == (8, E) and sched.dtype == torch.int32
    cfg32 = jcfg.with_(dtype="float32", root_tol=1e-6)
    f32 = [x.astype(jnp.float32) for x in (v0, s0, beta)]
    res_p, sched_p = interpreted.evolve_ensemble_pallas(
        cfg32, *f32, ii, record_schedule=E)
    res_x, sched_x = evolve_ensemble_batched(cfg32, None, *f32, ii,
                                             record_schedule=E)
    sched_np, n_np = to_numpy(sched), to_numpy(n_ev)
    for ref_n, ref_sched in ((res_p.n_events, sched_p),
                             (res_x.n_events, sched_x)):
        np.testing.assert_array_equal(n_np, np.asarray(ref_n))
        logged = np.arange(E)[None, :] < n_np[:, None]
        same = (sched_np == np.asarray(ref_sched)) & logged
        assert same.sum() >= 0.99 * logged.sum()
    rep = port_replay(setup, sched=to_torch(sched_p, torch.int32),
                      n_sched=to_torch(res_p.n_events, torch.int32))
    assert bool(rep.accept.all())


def test_overflow_rejects_only_that_row(setup):
    """n_sched > E rejects the row (tests/test_replay.py:116-124)."""
    n = setup["n_sched"].clone()
    n[0] = setup["sched"].shape[1] + 5
    rep, ref = port_replay(setup, n_sched=n), port_replay(setup)
    assert not bool(rep.accept[0])
    assert torch.equal(rep.accept[1:], ref.accept[1:])
    assert int(rep.n_events[0]) == int(n[0])


def test_padding_is_bitwise_invariant(setup):
    """A wider log with a dead tail changes no bit
    (tests/test_replay.py:127-141)."""
    sched = setup["sched"]
    wide = torch.cat([sched, torch.zeros(sched.shape[0], 256,
                                         dtype=torch.int32)], dim=1)
    cfg_wide = setup["pcfg"].with_(max_events=setup["pcfg"].max_events + 256)
    for a, b in zip(port_replay(setup),
                    port_replay(setup, sched=wide, cfg=cfg_wide)):
        assert torch.equal(a, b)


def test_forced_misfire_rejects_only_its_row(setup):
    """Row 2's first event is replaced by a lane that cannot fire from the
    initial state: the row takes f32(0.05) instead, is rejected, and no NaN
    appears anywhere; every other row is unchanged, and the JAX replay of
    the same log agrees on accept."""
    pcfg = setup["pcfg"]
    a = setup["port_in"]
    cfg32 = pcfg.with_(dtype="float32", root_tol=1e-6)
    times = pt.event_time(a["v0"][0].float(), a["s0"][0].float(),
                          a["beta"][2].float(), cfg32)
    dead = int(torch.nonzero(times >= 100.0)[0, 0])
    sched = setup["sched"].clone()
    sched[2, 0] = dead
    rep, ref = port_replay(setup, sched=sched), port_replay(setup)
    assert not bool(rep.accept[2])
    assert bool(ref.accept[2])
    for x in rep:
        assert bool(torch.isfinite(x.double()).all())
    keep = [r for r in range(8) if r != 2]
    for x, y in zip(rep, ref):
        assert torch.equal(x[keep], y[keep])
    v0, s0, beta, ii = setup["jax_in"]
    jrep = jreplay.replay_events(setup["jcfg"], jnp.asarray(to_numpy(sched)),
                                 setup["res64"].n_events, v0, s0, beta, ii)
    np.testing.assert_array_equal(to_numpy(rep.accept),
                                  np.asarray(jrep.accept))


def test_f32_inputs_track_the_f64_evolution(setup):
    """f32 inputs are replayed in fp64 and come within 1e-6 of the f64
    evolution of the same (f32-rounded) inputs, far closer than the plain
    f32 evolve (tests/test_replay.py:87-113)."""
    jcfg, pcfg = setup["jcfg"], setup["pcfg"]
    a = setup["port_in"]
    v32, s32, b32 = (a[k].float() for k in ("v0", "s0", "beta"))
    ii = a["init_ind"]
    sched, n_ev = pt.compute_schedule(pcfg, v32, s32, b32, ii[None])
    rep = pt.replay_events(pcfg, sched, n_ev, v32, s32, b32, ii)
    assert rep.crossed_time.dtype == torch.float32
    ref = evolve_ensemble_batched(
        jcfg, None, *(jnp.asarray(to_numpy(x), jnp.float64)
                      for x in (v32[0], s32[0], b32)),
        jnp.asarray(to_numpy(ii)))
    plain = pt.evolve_ensemble(pcfg.with_(dtype="float32", root_tol=1e-6),
                               v32, s32, b32, ii[None])
    want = np.asarray(ref.crossed_time)
    err_rep = np.abs(to_numpy(rep.crossed_time).astype(np.float64)
                     - want).max()
    err_plain = np.abs(to_numpy(plain.crossed_time).astype(np.float64)
                       - want).max()
    assert err_rep < 1e-6
    assert err_rep < 0.05 * err_plain


@pytest.mark.parametrize("sigma, atol", [(0.1, 1e-10), (1.0, 1e-5)])
def test_replay_map_matches_jax(setup, sigma, atol):
    """event_driven_map(..., "replay") against the JAX replay map within
    1e-10 (tests/test_replay.py:80-84); at sigma 1.0 (rejected
    realisations, grazing events) finite and within 1e-5 of the JAX f64
    map (:401-411).  On the CPU it launches no kernel."""
    jcfg, pcfg = setup["jcfg"], setup["pcfg"]
    jp, pp = params(sigma=sigma)
    beta = jax_draw(jcfg, jp)
    before = (evolve_cuda.LAUNCHES, replay_cuda.LAUNCHES)
    f = pt.event_driven_map(pcfg, pp, to_torch(beta), torch.tensor(Z0),
                            evolve_backend="replay")
    assert (evolve_cuda.LAUNCHES, replay_cuda.LAUNCHES) == before
    assert bool(torch.isfinite(f).all())
    ref = jx.event_driven_map(jcfg, jp, KEY, jnp.asarray(Z0),
                              evolve_backend="replay" if sigma < 1 else "xla")
    np.testing.assert_allclose(to_numpy(f), np.asarray(ref), rtol=0,
                               atol=atol)


def test_discrete_outcome_and_frozen_maps_match_jax(setup):
    """compute_discrete_outcome against the JAX one: the same seeding, and
    a log that extends the JAX log (the port's discovery pass runs
    DISCOVERY_MARGIN past T) and agrees with it on >= 99% of the JAX log's
    entries; replaying either outcome gives the same result (a row stops
    once all its trajectories crossed).  frozen_schedule_map_batched on the
    JAX outcome within 1e-12 of the JAX one at the (n+1)- and (2n+1)-point
    stencils; and at the discovery point the frozen map equals the replay
    map."""
    jcfg, pcfg, jp, pp = (setup[k] for k in ("jcfg", "pcfg", "jp", "pp"))
    beta = to_torch(setup["beta"])
    z = torch.tensor(Z0)
    sched, n_ev, ii = pt.compute_discrete_outcome(pcfg, pp, beta, z)
    jsched, jn, jii = jemap.compute_discrete_outcome(jcfg, jp, KEY,
                                                     jnp.asarray(Z0))
    np.testing.assert_array_equal(to_numpy(ii), np.asarray(jii))
    assert bool((to_numpy(n_ev) > np.asarray(jn)).all())
    logged = np.arange(sched.shape[1])[None, :] < np.asarray(jn)[:, None]
    assert ((to_numpy(sched) == np.asarray(jsched)) & logged).sum() \
        >= 0.99 * logged.sum()

    eps = 1e-5
    e = eps * np.eye(3)
    pts = np.concatenate([Z0[None], Z0[None] + e, Z0[None] - e])
    ref = np.asarray(jemap.frozen_schedule_map_batched(
        jcfg, jp, KEY, jnp.asarray(pts), jsched, jn, jii))
    outcome = (to_torch(jsched, torch.int32), to_torch(jn, torch.int32),
               to_torch(jii, torch.int32))
    a = setup["port_in"]
    for x, y in zip(pt.replay_events(pcfg, sched, n_ev, a["v0"], a["s0"],
                                     beta, ii),
                    pt.replay_events(pcfg, *outcome[:2], a["v0"], a["s0"],
                                     beta, outcome[2])):
        if x.dtype != torch.int32 or x.ndim == 2:     # n_events differ
            assert torch.equal(x, y)
    for n_pts in (4, 7):
        got = pt.frozen_schedule_map_batched(
            pcfg, pp, beta, torch.tensor(pts[:n_pts]), *outcome)
        assert got.shape == (n_pts, 3)
        np.testing.assert_allclose(to_numpy(got), ref[:n_pts], rtol=0,
                                   atol=1e-12)
    f_frozen = pt.frozen_schedule_map(pcfg, pp, beta, z, sched, n_ev, ii)
    f_replay = pt.event_driven_map(pcfg, pp, beta, z,
                                   evolve_backend="replay")
    assert torch.equal(f_frozen, f_replay)


def replay_args(dtype=torch.float64, P=1, R=2, N=256, E=128):
    cfg = pt.ModelConfig(n_neurons=N, n_real=R, dtype="float64")
    return cfg, dict(sched=torch.zeros(R, E, dtype=torch.int32),
                     n_sched=torch.zeros(R, dtype=torch.int32),
                     v0=torch.zeros(P, N, dtype=dtype),
                     s0=torch.zeros(P, N, dtype=dtype),
                     beta=torch.ones(R, N, dtype=dtype),
                     init_ind=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    "cpu", "sched_rows", "n_sched_shape", "init_shape", "sched_dtype",
    "mixed_dtype", "half", "strided"])
def test_replay_kernel_wrapper_refuses_without_launching(bad):
    """K2's wrapper raises on CPU tensors and, before that, on shapes,
    dtypes and strides the kernel does not take; nothing launches."""
    cfg, a = replay_args()
    if bad == "sched_rows":
        a["sched"] = torch.zeros(3, 128, dtype=torch.int32)
    elif bad == "n_sched_shape":
        a["n_sched"] = torch.zeros(3, dtype=torch.int32)
    elif bad == "init_shape":
        a["init_ind"] = torch.zeros(2, 3, dtype=torch.int32)
    elif bad == "sched_dtype":
        a["sched"] = a["sched"].long()
    elif bad == "mixed_dtype":
        a["s0"] = a["s0"].float()
    elif bad == "half":
        a = {k: v.half() if v.is_floating_point() else v
             for k, v in a.items()}
    elif bad == "strided":
        a["sched"] = torch.zeros(128, 2, dtype=torch.int32).T
    before = replay_cuda.LAUNCHES
    with pytest.raises((ValueError, TypeError),
                       match="CUDA" if bad == "cpu" else None):
        replay_cuda.replay_events_cuda(cfg, **a)
    assert replay_cuda.LAUNCHES == before
    if bad == "cpu":
        out = pt.replay_events(cfg, **a)        # the plain version runs
        assert out.accept.shape == (2,)


def test_logging_evolve_wrapper_refuses_cpu_tensors():
    _, pcfg = configs(n_neurons=256, n_real=2, dtype="float32")
    x = torch.zeros(1, 256)
    before = evolve_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        evolve_cuda.evolve_ensemble_cuda(
            pcfg, x, x, torch.ones(2, 256),
            torch.zeros(1, 3, dtype=torch.int32), record_schedule=128)
    assert evolve_cuda.LAUNCHES == before
