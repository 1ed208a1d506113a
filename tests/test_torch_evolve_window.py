"""Port parity of the certified evolve window: the port's plain windowed
evolve (``model/evolve_batched.py``) against the JAX package's
``evolve_ensemble_batched`` and against the port's own every-lane evolve,
on the CPU; and the shared-memory rule the CUDA wrappers choose a kernel
variant by (``model/evolve_cuda.py::row_fits_shared``).

Inputs are the JAX ``sample_beta`` draw, or a numpy-seeded draw, and lifts
of the ``Driver.cu`` guess, fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_certificate import log_form_fallbacks
from torch_parity import (INITIAL_GUESS, configs, jax_draw, jx, params, pt,
                          to_numpy, to_torch)
from armadillocudalinearinterpolation_torch.model import emap, evolve_cuda
from armadillocudalinearinterpolation_torch.model.evolve_batched import (
    certificate_ratio, evolve_ensemble_batched, window_pad)
from armadillocudalinearinterpolation_torch.model.replay import (
    compute_schedule)
from armadillocudalinearinterpolation_tpu.model import (
    evolve_batched as jbatched)

FIELDS = ("last_ind", "last_time", "crossed_ind", "crossed_time", "accept",
          "n_events")


def lifted(pcfg, pp, Z):
    Zt = torch.tensor(np.atleast_2d(Z), dtype=pcfg.torch_dtype)
    v0, s0 = pt.lift(pcfg, pp, pt.z_to_u(Zt))
    return v0, s0, pt.initial_spike_indices(pcfg, Zt)


def assert_same(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def assert_matches_jax(res, ref):
    """Indices, accept and counts exactly; times to 1e-10 (the replay bar,
    tests/test_replay.py:51): the two packages' CPU ``exp`` differ in the
    last bits, 1e-14 apart on these times."""
    for name in ("last_ind", "crossed_ind", "accept", "n_events"):
        np.testing.assert_array_equal(to_numpy(getattr(res, name)),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("last_time", "crossed_time"):
        np.testing.assert_allclose(to_numpy(getattr(res, name)),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-10, err_msg=name)


@pytest.mark.parametrize("record", [0, 1024])
def test_windowed_plain_matches_jax_batched_and_every_lane(record):
    """f64, N=512, R=8, W=128: the port's windowed evolve is the JAX
    windowed evolve (same discrete outcome and log), and equals the port's
    every-lane evolve in every field."""
    jcfg, pcfg = configs(n_neurons=512, n_real=8, evolve_window=128)
    jp, pp = params(sigma=0.1)
    beta = jax_draw(jcfg, jp)
    v0, s0, ii = lifted(pcfg, pp, INITIAL_GUESS)
    fb = torch.zeros(8, dtype=torch.int32)
    got = evolve_ensemble_batched(pcfg, v0, s0, to_torch(beta), ii,
                                  record_schedule=record, fallbacks=fb)
    ref = jbatched.evolve_ensemble_batched(
        jcfg, None, *(jnp.asarray(to_numpy(x[0])) for x in (v0, s0)),
        jnp.asarray(beta), jnp.asarray(to_numpy(ii[0])),
        record_schedule=record)
    full = pt.evolve_ensemble(pcfg.with_(evolve_window=0), v0, s0,
                              to_torch(beta), ii, record_schedule=record)
    if record:
        (got, sched), (ref, jsched), (full, fsched) = got, ref, full
        np.testing.assert_array_equal(to_numpy(sched), np.asarray(jsched))
        assert torch.equal(sched, fsched)
    assert_matches_jax(got, ref)
    assert_same(got, full)
    assert bool(got.accept.all()) and int(got.n_events.min()) > 100
    # the window held: no row fell back at the guess
    assert int(fb.sum()) == 0


def test_forced_fallback_stays_exact():
    """tests/test_evolve_batched.py:58-90: spikes spread far beyond one
    128-lane window force the certificate's fallback; the results still
    equal the every-lane evolve's, and the JAX package's, and each row falls
    back at as many events as under the JAX package's per-lane log form of
    the certificate."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, evolve_window=128)
    jp, pp = params(sigma=0.0)
    U = np.array([0.3262, 0.0, 0.7194, 1.3690])
    v0, s0 = pt.lift(pcfg, pp, torch.tensor(U)[None])
    beta = 13.0589 + 0.1 * np.random.default_rng(7).standard_normal((4, 512))
    init_ind = np.array([[420, 256, 60]], np.int32)
    fb = torch.zeros(4, dtype=torch.int32)
    got = evolve_ensemble_batched(pcfg, v0, s0, torch.from_numpy(beta),
                                  torch.from_numpy(init_ind), fallbacks=fb)
    full = pt.evolve_ensemble(pcfg, v0, s0, torch.from_numpy(beta),
                              torch.from_numpy(init_ind))
    assert_same(got, full)
    ref = jbatched.evolve_ensemble_batched(
        jcfg, None, jnp.asarray(to_numpy(v0[0])), jnp.asarray(to_numpy(s0[0])),
        jnp.asarray(beta), jnp.asarray(init_ind[0]))
    assert_matches_jax(got, ref)
    assert int(fb.min()) > 0
    assert bool((fb <= got.n_events).all())
    assert torch.equal(fb, log_form_fallbacks(
        pcfg, v0, s0, torch.from_numpy(beta), torch.from_numpy(init_ind)))


# The coexisting fast wave family's start (benchmark/traffic/
# sweep_fast_family.json) and the beta of its sweep's 25th step: one of its
# three tracked spikes sits at index 0 and never fires near there.
FAST_FAMILY = (0.4988, 0.5761, 11.0139)


@pytest.mark.parametrize("beta0", [13.3589, 15.7589])
def test_fast_family_window_holds(beta0):
    """f32, N=512, R=4, W=128 on the fast family: the windowed evolve
    equals the every-lane evolve; its window (one run per tracked spike,
    since the one run from the lowest tracked index does not hold them)
    falls back on under 5% of the events, where the one run (the JAX
    package's window) fails the certificate on over 90%; and the per-lane
    log form of the certificate counts the same fallbacks."""
    _, pcfg = configs(n_neurons=512, n_real=4, dtype="float32",
                      evolve_window=128)
    _, pp = params(beta=beta0, sigma=0.1, dtype="float32")
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(0))
    v0, s0, ii = lifted(pcfg, pp, FAST_FAMILY)
    assert int(ii.min()) == 0
    fb = torch.zeros(4, dtype=torch.int32)
    got = evolve_ensemble_batched(pcfg, v0, s0, beta, ii, fallbacks=fb)
    full = pt.evolve_ensemble(pcfg, v0, s0, beta, ii)
    assert_same(got, full)
    events = int(got.n_events.sum())
    assert bool(got.accept.all()) and events > 1000
    assert int(fb.sum()) < 0.05 * events
    assert torch.equal(fb, log_form_fallbacks(pcfg, v0, s0, beta, ii))
    single = log_form_fallbacks(pcfg, v0, s0, beta, ii, single_window=True)
    assert int(single.sum()) > 0.9 * events


def test_f32_windowed_map_matches_the_jax_windowed_map():
    """f32, N=512, R=4, W=128: the port's map on the plain windowed evolve
    against the JAX map on its windowed batched evolve, at the f32
    residual bar (tests/test_evolve_pallas.py:91)."""
    jcfg, pcfg = configs(n_neurons=512, n_real=4, dtype="float32",
                         evolve_window=128)
    jp, pp = params(sigma=0.1, dtype="float32")
    z = np.asarray(INITIAL_GUESS, np.float32)
    f_jax = jx.event_driven_map(jcfg, jp, jax.random.PRNGKey(0),
                                jnp.asarray(z), evolve_backend="xla")
    f_port = pt.event_driven_map(pcfg, pp, to_torch(jax_draw(jcfg, jp)),
                                 torch.tensor(z), evolve_backend="torch")
    assert f_port.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(f_port), np.asarray(f_jax), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("backend", ["torch", "auto", "replay"])
def test_map_with_and_without_the_window_is_equal(backend):
    """The window changes no residual of the map, on the plain evolve, on
    the "auto" route of CPU tensors and in the replay's discovery pass."""
    _, pcfg = configs(n_neurons=512, n_real=4)
    _, pp = params(sigma=0.1)
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(3))
    Z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)
    Zs = torch.stack([Z, Z + 1e-3])
    f0 = pt.event_driven_map(pcfg, pp, beta, Zs, evolve_backend=backend)
    fw = pt.event_driven_map(pcfg.with_(evolve_window=128), pp, beta, Zs,
                             evolve_backend=backend)
    assert torch.equal(f0, fw)


def test_discovery_log_with_the_window_is_the_full_log():
    """compute_schedule runs the windowed evolve with its log (config 4's
    discovery passes use both): the same log and counts as every lane."""
    _, pcfg = configs(n_neurons=512, n_real=4, max_events=1024)
    _, pp = params(sigma=0.1)
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(5))
    v0, s0, ii = lifted(pcfg, pp, INITIAL_GUESS)
    s_full, n_full = compute_schedule(pcfg, v0, s0, beta, ii)
    s_win, n_win = compute_schedule(pcfg.with_(evolve_window=256), v0, s0,
                                    beta, ii)
    assert torch.equal(s_full, s_win) and torch.equal(n_full, n_win)


def test_plain_backends_resolve_to_the_windowed_evolve():
    for backend in ("torch", "auto"):
        assert emap.select_evolve(backend, torch.device("cpu")) \
            is evolve_ensemble_batched
    assert window_pad(128) == 32 and window_pad(512) == 64


def test_certificate_ratio_cases():
    """+inf where cap <= vth, 1 where beta <= 0, NaN where v is NaN, the
    floor where v >= cap; the bound is log of the ratio."""
    _, pcfg = configs(n_neurons=256, n_real=1)
    I, vth = pcfg.drive, pcfg.vth
    v = torch.tensor([0.5, 0.5, 0.5, float("nan"), 5.0, 0.5])
    s = torch.tensor([-1.0, 1.0, 1.0, 1.0, 1.0, float("nan")])
    b = torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0])
    r = certificate_ratio(pcfg, v.double(), s.double(), b.double())
    assert r[0] == float("inf")
    assert float(r[1]) == pytest.approx((I + 1.0 - 0.5) / (I + 1.0 - vth))
    assert r[2] == 1.0
    assert bool(r[3].isnan())
    assert float(r[4]) == pytest.approx(1e-300 / (I + 1.0 - vth))
    assert r[5] == float("inf")   # NaN synapse: cap - vth > 0 is False


# ------------------------------------------------- shared-memory selection

@pytest.mark.parametrize("dtype, kind, n_max", [
    (torch.float32, "evolve", 16515), (torch.float64, "evolve", 8267),
    (torch.float32, "replay", 8297), (torch.float64, "replay", 8297)])
def test_row_fits_shared_at_its_limits(dtype, kind, n_max):
    """The largest N whose row state fits the 232,448-byte opt-in, for 3
    trajectories: 3N row values and the N/2 + 1 kick table in the value
    type (fp64 for the replay whatever the states' type) plus the small
    arrays."""
    assert evolve_cuda.row_fits_shared(n_max, 3, dtype, kind)
    assert not evolve_cuda.row_fits_shared(n_max + 1, 3, dtype, kind)
    assert evolve_cuda.row_shared_bytes(n_max + 1, 3, dtype, kind) > \
        evolve_cuda.SHARED_OPTIN_BYTES


def test_row_fits_shared_follows_the_cards_limit():
    """A card whose blocks opt in to less shared memory (99 KB, as on
    sm_86) sends config 4's rows to the device-memory variant."""
    for kind in ("evolve", "replay"):
        assert evolve_cuda.row_fits_shared(4096, 3, torch.float64, kind)
        assert not evolve_cuda.row_fits_shared(4096, 3, torch.float64, kind,
                                               101_376)
        assert evolve_cuda.row_fits_shared(1024, 3, torch.float64, kind,
                                           101_376)


def test_row_shared_bytes_counts_every_array():
    item = {torch.float32: 4, torch.float64: 8}
    warps = {torch.float32: 32, torch.float64: 16}
    for dtype in item:
        for N, M in ((512, 3), (4096, 3), (1001, 5)):
            # the trajectories' times, two slots of per-warp winners and
            # bounds; two copies of the tracked indices and flags, the
            # crossing indices, two slots of per-warp winners' indices and
            # each warp's M ranked window starts
            w = warps[dtype]
            small = ((2 * M + 4 * w) * item[dtype]
                     + (5 * M + 2 * w + w * M) * 4)
            table = (N // 2 + 1) * item[dtype]
            assert evolve_cuda.row_shared_bytes(N, M, dtype, "evolve") == \
                3 * N * item[dtype] + table + small
    # the replay's 112 KB at N=4096 (csrc/replay.cu)
    assert evolve_cuda.row_shared_bytes(4096, 3, torch.float32,
                                        "replay") == 114_804
    # the card tests' large-N rows take device memory
    assert not evolve_cuda.row_fits_shared(10240, 3, torch.float64, "evolve")
    assert not evolve_cuda.row_fits_shared(8448, 3, torch.float64, "replay")
    assert evolve_cuda.row_fits_shared(4096, 3, torch.float64, "evolve")
    with pytest.raises(ValueError, match="kind"):
        evolve_cuda.row_shared_bytes(512, 3, torch.float32, "lift")


@pytest.mark.parametrize("N, rows, dtype, threads", [
    (1024, 1024, torch.float32, 128),   # config 3: the rows fill the card
    (512, 3000, torch.float32, 64),     # the slice's FD stack
    (4096, 384, torch.float32, 256),    # config 4's f32 Newton stage
    (4096, 256, torch.float64, 256),    # config 4's f64 stage
    (4096, 64, torch.float32, 512),     # config 4's discovery pass
    (10240, 2, torch.float64, 512),
    (40, 1, torch.float32, 64), (20, 1, torch.float64, 32)])
def test_default_threads_fill_the_card(N, rows, dtype, threads):
    assert evolve_cuda.default_threads(N, rows, 132, dtype) == threads
