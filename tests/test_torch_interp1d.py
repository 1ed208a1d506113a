"""The port's 1-D interpolation against the JAX package, on the CPU.

``ops/interp.py::lerp_uniform`` is held against the JAX ``lerp_uniform``
and ``numpy.interp`` at extreme queries; the entry points of
``ops/interp1d_cuda.py`` on CPU tensors (the kernels' plain versions)
against the JAX ``ops/interp_pallas.py`` in interpret mode, at the shapes
of ``tests/test_interp_pallas.py``.  Inputs are made with numpy from a seed
and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import pt
from armadillocudalinearinterpolation_torch.ops import interp
from armadillocudalinearinterpolation_torch.ops import interp1d_cuda as i1
from armadillocudalinearinterpolation_tpu.ops import interp as jinterp
from armadillocudalinearinterpolation_tpu.ops import interp_pallas

EXTREME = [1e30, -1e30, 1e12, -1e12, np.inf, -np.inf, np.nan]


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def both(fn_t, fn_j, *arrays):
    """``fn_t`` on torch tensors and ``fn_j`` on JAX arrays of the same
    numpy inputs, as numpy."""
    got = fn_t(*(torch.from_numpy(a) for a in arrays))
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    return got.numpy(), np.asarray(want)


def sin_table(n, dtype=np.float32):
    """The bench's table: ``sin`` at ``n`` nodes on [-3, 3]."""
    return np.sin(np.linspace(-3, 3, n)).astype(dtype), -3.0, 6.0 / (n - 1)


def uniform_ref(xq, fp, x0, dx):
    """``numpy.interp`` in float64 on the nodes ``x0 + i*dx``."""
    return np.interp(np.asarray(xq, np.float64),
                     x0 + dx * np.arange(fp.shape[0]),
                     np.asarray(fp, np.float64))


# ------------------------------------------ lerp_uniform at the extremes

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lerp_uniform_saturates_at_extreme_queries(dtype):
    fp, x0, dx = sin_table(1000, dtype)
    rng = np.random.default_rng(0)
    xq = np.concatenate([EXTREME, rng.uniform(-3.5, 3.5, 500)]).astype(dtype)
    got, want = both(lambda q, f: interp.lerp_uniform(q, f, x0, dx),
                     lambda q, f: jinterp.lerp_uniform(q, f, x0, dx), xq, fp)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ref = uniform_ref(xq, fp, x0, dx)
    np.testing.assert_allclose(got[:7], ref[:7], rtol=0, atol=1e-6)
    # the last node's value on the right, the first node's on the left
    np.testing.assert_allclose(got[[0, 2, 4]], fp[-1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[[1, 3, 5]], fp[0], rtol=0, atol=1e-6)
    assert np.isnan(got[6])


# ------------------------------------------------- lerp1d (K3) vs Pallas

def test_lerp1d_matches_pallas(interpret):
    fp, x0, dx = sin_table(1000)
    rng = np.random.default_rng(1)
    xq = rng.uniform(-3.5, 3.5, 9001).astype(np.float32)   # odd size
    got, want = both(lambda q, f: i1.lerp1d(q, f, x0, dx),
                     lambda q, f: interp_pallas.lerp1d(q, f, x0, dx), xq, fp)
    assert got.shape == xq.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, uniform_ref(xq, fp, x0, dx), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 100, 128, 129, 4096, 8192])
def test_lerp1d_table_sizes_match_pallas(interpret, n):
    fp = np.arange(n, dtype=np.float32) ** 1.5
    xq = np.random.default_rng(n).uniform(-1.0, n, 257).astype(np.float32)
    got, want = both(lambda q, f: i1.lerp1d(q, f, 0.0, 1.0),
                     lambda q, f: interp_pallas.lerp1d(q, f, 0.0, 1.0),
                     xq, fp)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_lerp1d_is_k3s_formula_not_lerp_uniforms():
    """K3 multiplies by an f32 ``1/dx``; ``lerp_uniform`` divides by
    ``dx``.  The plain version follows the kernel, so it can differ from
    ``lerp_uniform`` by rounding, and from nothing else."""
    fp, x0, dx = sin_table(1000)
    q = torch.from_numpy(np.random.default_rng(2).uniform(
        -3.5, 3.5, 20001).astype(np.float32))
    f = torch.from_numpy(fp)
    x0_32, inv_dx = i1.uniform_lims(x0, dx)
    assert (x0_32, inv_dx) == tuple(np.array([x0, 1 / dx], np.float32))
    got = i1.lerp1d(q, f, x0, dx)
    assert torch.equal(got, i1.lerp1d_plain(q, f, x0_32, inv_dx))
    assert float((got - interp.lerp_uniform(q, f, x0, dx)).abs().max()) < 1e-6


# --------------------------------------------- lerp1d_binned (K4) vs Pallas

def _binned_queries(case):
    rng = np.random.default_rng(13)
    uni = rng.uniform(-1.0, 21.0, 70000).astype(np.float32)
    return {"uniform": (uni, 16),
            "skewed": (np.concatenate([uni, np.full(3000, 5.5, np.float32)]),
                       8),
            "2048_queries": (uni[:2048], 2),
            "exact_fit": (uni[:16 * 128 * 4], 16)}[case]


@pytest.mark.parametrize("case", ["uniform", "skewed", "2048_queries",
                                  "exact_fit"])
def test_lerp1d_binned_matches_pallas(interpret, case):
    n = 16384
    fp = np.cos(np.linspace(0, 20, n)).astype(np.float32)
    dx = 20.0 / (n - 1)
    xq, nb = _binned_queries(case)
    got, want = both(
        lambda q, f: i1.lerp1d_binned(q, f, 0.0, dx, n_batches=nb),
        lambda q, f: interp_pallas.lerp1d_binned(q, f, 0.0, dx,
                                                 n_batches=nb), xq, fp)
    assert got.shape == xq.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # K4 is K3's function: the sorted route gives K3's bits
    direct = i1.lerp1d_plain(torch.from_numpy(xq), torch.from_numpy(fp),
                             *i1.uniform_lims(0.0, dx))
    np.testing.assert_array_equal(got, direct.numpy())


@pytest.mark.parametrize("Q, nb", [(1, 8), (10, 512), (4097, 8), (70000, 16),
                                   (262150, 64)])
def test_sort_batches_sorts_contiguous_id_ranges(Q, nb):
    q = torch.from_numpy(np.random.default_rng(Q).uniform(
        -1, 1, Q).astype(np.float32))
    q[::97] = float("nan")
    qs, order = i1.sort_batches(q, nb)
    Qb = -(-Q // nb)
    assert qs.shape == order.shape == (nb * Qb,)
    assert torch.equal(torch.sort(order).values, torch.arange(nb * Qb))
    rows = order.view(nb, Qb)
    assert bool(((rows // Qb) == torch.arange(nb)[:, None]).all())
    real = order < Q
    assert torch.equal(qs[real].isnan(), q[order[real]].isnan())
    ok = real & ~qs.isnan()
    assert torch.equal(qs[ok], q[order[ok]])
    f32_max = float(np.finfo(np.float32).max)
    assert bool((qs[~real] == f32_max).all())
    # ascending in each row, NaN last
    assert bool((qs.view(nb, Qb).nan_to_num(nan=f32_max).diff(dim=1) >= 0)
                .all())


# ----------------------------------------------------------- routing

def test_pow2_batches_is_the_jax_rule():
    for Q in [0, 1, 4095, 4096, 8192, 40000, 131072, 200000, 2_097_152,
              2_097_153, 10_000_000]:
        assert i1._pow2_batches(Q) == interp_pallas._pow2_batches(Q), Q
    assert i1._pow2_batches(2_097_152) == 512


# The JAX package's rule sends the first two to its sorted kernel; on the
# card the sort costs more than K3 at every shape measured
# (tools/interp1d_route_study.py), so no size takes the sorted route.
@pytest.mark.parametrize("n, Q, sorted_route", [
    (65536, 200_000, False), (8193, 131072, False), (8192, 200_000, False),
    (65536, 131071, False)])
def test_lerp1d_routes_by_the_jax_rule(monkeypatch, n, Q, sorted_route):
    fp, x0, dx = sin_table(n)
    xq = np.random.default_rng(19).uniform(-3.2, 3.2, Q).astype(np.float32)
    calls = []
    binned = i1.lerp1d_binned

    def spy(*args, **kw):
        calls.append(kw["n_batches"])
        return binned(*args, **kw)

    monkeypatch.setattr(i1, "lerp1d_binned", spy)
    got = i1.lerp1d(torch.from_numpy(xq), torch.from_numpy(fp), x0, dx)
    assert calls == ([interp_pallas._pow2_batches(Q)] if sorted_route
                     else [])
    want = interp.lerp_uniform(torch.from_numpy(xq), torch.from_numpy(fp),
                               x0, dx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_routed_f64_queries_keep_their_dtype():
    fp, x0, dx = sin_table(16384, np.float64)
    xq = np.random.default_rng(21).uniform(-3.0, 3.0, 131072)
    got = i1.lerp1d(torch.from_numpy(xq), torch.from_numpy(fp), x0, dx)
    assert got.dtype == torch.float64 and got.shape == xq.shape
    np.testing.assert_allclose(got.numpy(), uniform_ref(xq, fp, x0, dx),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", ["lerp1d", "lerp1d_binned", "interp1d"])
def test_empty_and_shaped_queries(fn):
    fp, x0, dx = sin_table(300)
    f = torch.from_numpy(fp)
    xp = torch.linspace(-3, 3, 300)
    call = {"lerp1d": lambda q: i1.lerp1d(q, f, x0, dx),
            "lerp1d_binned": lambda q: i1.lerp1d_binned(q, f, x0, dx),
            "interp1d": lambda q: i1.interp1d(q, xp, f)}[fn]
    empty = call(torch.empty(0, 3, dtype=torch.float64))
    assert empty.shape == (0, 3) and empty.dtype == torch.float64
    q = torch.from_numpy(np.random.default_rng(3).uniform(
        -4, 4, (7, 11, 3)))
    got = call(q)
    assert got.shape == (7, 11, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy().ravel(),
                               uniform_ref(q.numpy().ravel(), fp, x0, dx),
                               rtol=0, atol=1e-5)


# -------------------------------------------- make_interp1d (K5) vs Pallas

def nonuniform(seed, n, g0, scale):
    """Nodes from gaps ``g0 + U[0, 1)`` (f32 cumsum, as the JAX tests
    make them) and ``fp = sin(scale * xp)``."""
    gaps = (g0 + np.random.default_rng(seed).uniform(0, 1, n - 1)).astype(
        np.float32)
    xp = np.concatenate([[0.0], np.cumsum(gaps)]).astype(np.float32)
    return xp, np.sin(scale * xp).astype(np.float32)


def dense_cluster():
    """``tests/test_interp_pallas.py:125-131``: 100 nodes within 2e-2."""
    xp = np.concatenate([np.linspace(0.0, 1.0, 50),
                         1.0 + np.linspace(1e-4, 2e-2, 100),
                         np.linspace(1.1, 10.0, 30)]).astype(np.float32)
    fp = np.random.default_rng(0).standard_normal(xp.shape[0]).astype(
        np.float32)
    return xp, fp


def test_interp1d_matches_pallas(interpret):
    xp, _ = nonuniform(12, 700, 0.05, 0.3)
    fp = (np.sin(0.3 * xp) + 0.1 * xp).astype(np.float32)
    xq = np.random.default_rng(13).uniform(-2.0, xp[-1] + 2.0, 1025).astype(
        np.float32)
    got, want = both(i1.interp1d, interp_pallas.interp1d, xq, xp, fp)
    assert got.shape == xq.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.interp(xq, xp, fp), rtol=1e-5,
                               atol=1e-5)


def test_interp1d_dense_cluster_matches_pallas(interpret):
    xp, fp = dense_cluster()
    xq = np.random.default_rng(14).uniform(0.9, 1.2, 777).astype(np.float32)
    table = i1.make_interp1d(torch.from_numpy(xp), torch.from_numpy(fp))
    assert table.S > 50          # the cluster's long advance
    got = table(torch.from_numpy(xq)).numpy()
    want = np.asarray(interp_pallas.interp1d(jnp.asarray(xq), jnp.asarray(xp),
                                             jnp.asarray(fp)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.interp(xq, xp, fp), rtol=1e-4,
                               atol=1e-4)


def test_interp1d_sorted_route_matches_pallas(interpret, monkeypatch):
    xp, fp = nonuniform(14, 2048, 0.05, 0.07)
    xq = np.random.default_rng(15).uniform(-1.0, xp[-1] + 1.0, 262150).astype(
        np.float32)
    sorts = []
    sort_batches = i1.sort_batches
    monkeypatch.setattr(i1, "sort_batches",
                        lambda q, nb: sorts.append(nb) or sort_batches(q, nb))
    table = i1.make_interp1d(torch.from_numpy(xp), torch.from_numpy(fp))
    direct = table(torch.from_numpy(xq))
    assert sorts == []                  # the default route sorts nothing
    got = table(torch.from_numpy(xq), method="sorted")
    assert sorts == [64]
    assert torch.equal(got, direct)
    want = np.asarray(interp_pallas.make_interp1d(
        jnp.asarray(xp), jnp.asarray(fp))(jnp.asarray(xq)))
    assert got.shape == xq.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # the sorted route is the direct route's function, bit for bit
    assert torch.equal(got, i1.interp1d_plain(table, torch.from_numpy(xq)))


def test_interp1d_host_prep_is_the_jax_prep():
    xp, fp = nonuniform(4, 4096, 0.1, 0.05)
    table = i1.make_interp1d(torch.from_numpy(xp), torch.from_numpy(fp))
    xp_h = xp.astype(np.float64)
    m = 16384                 # 4 buckets per node, as a power of two
    edges = xp_h[0] + (xp_h[-1] - xp_h[0]) * np.arange(m) / m
    bucket = np.clip(np.searchsorted(xp_h, edges, side="right") - 1, 0,
                     4094)
    assert table.m == m and table.n == 4096
    np.testing.assert_array_equal(table.bucket.numpy(), bucket)
    assert table.bucket.dtype == torch.int32
    assert table.nodes.shape == (4096, 4)
    np.testing.assert_array_equal(table.nodes[:, 0].numpy(), xp)
    np.testing.assert_array_equal(table.nodes[:-1, 1].numpy(), xp[1:])
    np.testing.assert_array_equal(table.nodes[:, 2].numpy(), fp)
    assert table.nodes[-1, 1] == np.inf and table.nodes[-1, 3] == 0
    assert table.lims == tuple(np.array(
        [xp_h[0], m / (xp_h[-1] - xp_h[0]), xp_h[0], xp_h[-1]], np.float32))
    assert 2 <= table.S <= 8


BRACKET_CASES = {
    "gaps_0.1": lambda: nonuniform(4, 4096, 0.1, 0.05),
    "gaps_0.001": lambda: nonuniform(5, 1000, 0.001, 1.0),
    "dense_cluster": dense_cluster,
    "geometric": lambda: ((1.01 ** np.arange(600)).astype(np.float32),
                          np.zeros(600, np.float32)),
    "two_nodes": lambda: (np.array([-1.0, 2.5], np.float32),
                          np.array([3.0, -1.0], np.float32)),
}


@pytest.mark.parametrize("case", list(BRACKET_CASES))
def test_interp1d_bracket_is_searchsorteds(case):
    xp, fp = BRACKET_CASES[case]()
    table = i1.make_interp1d(torch.from_numpy(xp), torch.from_numpy(fp))
    rng = np.random.default_rng(7)
    qc = np.concatenate([rng.uniform(xp[0], xp[-1], 20000), xp,
                         np.nextafter(xp, -np.inf).clip(xp[0]),
                         np.nextafter(xp, np.inf).clip(max=xp[-1])])
    qc = torch.from_numpy(qc.astype(np.float32))
    lo = i1.interp1d_bracket(table, qc)
    n = xp.shape[0]
    want = np.clip(np.searchsorted(xp, qc.numpy(), side="right") - 1, 0,
                   n - 2)
    np.testing.assert_array_equal(lo.numpy(), want)
    x32 = torch.from_numpy(xp)
    assert bool(((x32[lo] <= qc) & ((qc < x32[lo + 1]) | (lo == n - 2)))
                .all())


def test_interp1d_extreme_queries_take_the_end_values():
    xp, fp = nonuniform(6, 129, 0.1, 0.5)
    xq = np.array(EXTREME + [xp[0], xp[-1], -3.0], np.float32)
    got = i1.interp1d(torch.from_numpy(xq), torch.from_numpy(xp),
                      torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(got, np.interp(xq, xp, fp), rtol=0,
                               atol=1e-6)
    assert np.isnan(got[6])


# -------------------------------------------------------------- errors

def test_errors_are_the_jax_errors():
    big = MAX = i1.MAX_TABLE
    assert MAX == interp_pallas.MAX_TABLE
    with pytest.raises(ValueError, match="table too large"):
        interp_pallas.lerp1d(jnp.zeros(8), jnp.zeros(big + 1), 0.0, 1.0)
    for fn in (i1.lerp1d, i1.lerp1d_binned):
        with pytest.raises(ValueError, match="table too large"):
            fn(torch.zeros(8), torch.zeros(big + 1), 0.0, 1.0)
        with pytest.raises(ValueError, match="at least 2"):
            fn(torch.zeros(8), torch.zeros(1), 0.0, 1.0)
    cases = [(np.array([0.0, 2.0, 1.0]), np.zeros(3), "strictly increasing"),
             (np.array([0.0, 1.0, 1.0]), np.zeros(3), "strictly increasing"),
             (np.array([0.0]), np.zeros(1), "at least 2"),
             (np.arange(big + 1.0), np.zeros(big + 1), "table too large")]
    for xp, fp, msg in cases:
        with pytest.raises(ValueError, match=msg):
            interp_pallas.make_interp1d(jnp.asarray(xp), jnp.asarray(fp))
        with pytest.raises(ValueError, match=msg):
            i1.make_interp1d(torch.from_numpy(xp), torch.from_numpy(fp))


def test_entry_points_reject_what_they_do_not_take():
    q, f = torch.zeros(5), torch.linspace(0, 1, 4)
    with pytest.raises(TypeError, match="floating"):
        i1.lerp1d(q.int(), f, 0.0, 1.0)
    with pytest.raises(ValueError, match="one device"):
        i1.lerp1d(q, f.to("meta"), 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        i1.lerp1d(q.to("meta"), f.to("meta"), 0.0, 1.0)
    with pytest.raises(ValueError, match="1-D"):
        i1.lerp1d(q, f[None], 0.0, 1.0)
    with pytest.raises(ValueError, match="n_batches"):
        i1.lerp1d_binned(q, f, 0.0, 1.0, n_batches=0)
    with pytest.raises(ValueError, match=r"\(n,\)"):
        i1.make_interp1d(f, f[:3])
    with pytest.raises(ValueError, match="one device"):
        i1.make_interp1d(f, f)(q.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    q, f = torch.zeros(5), torch.linspace(0, 1, 4)
    table = i1.make_interp1d(f, f)
    qs, order = i1.sort_batches(q, 8)
    before = dict(i1.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        i1.lerp1d_cuda(q, f, 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        i1.lerp1d_sorted_cuda(qs, order, f, 0.0, 1.0, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        i1.interp1d_cuda(table, q)
    with pytest.raises(ValueError, match="CUDA"):
        i1.interp1d_cuda(table, qs, order, 5)
    # the CPU path runs the plain versions and launches nothing
    pt.lerp1d(q, f, 0.0, 1.0)
    pt.lerp1d_binned(q, f, 0.0, 1.0)
    table(q)
    assert i1.LAUNCHES == before
