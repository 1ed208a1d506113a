"""The port's interpolation against the JAX package, on the CPU.

The plain functions of ``ops/interp.py`` are held against the JAX
``ops/interp.py``; the entry points of ``ops/interp_cuda.py`` on CPU tensors
(the kernels' plain versions) against the JAX ``ops/interp_pallas.py`` in
interpret mode, at the shapes of ``tests/test_interp_pallas.py``.  Inputs
are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import pt
from armadillocudalinearinterpolation_torch.ops import interp, interp_cuda
from armadillocudalinearinterpolation_tpu.ops import interp as jinterp
from armadillocudalinearinterpolation_tpu.ops import interp_pallas

ATOL = {"float32": 1e-6, "float64": 1e-12}
PALLAS_ATOL = 2e-4      # the Pallas bf16x2 bar (tests/test_interp_pallas.py)
BF16_BAR = 0.05         # bf16-level (tests/test_interp_pallas.py:79)
F64_ATOL = 1e-13        # tests/test_interp_pallas.py:203


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def grids_pts(seed, B, H, W, Q, lo, hi, dtype=np.float32):
    rng = np.random.default_rng(seed)
    grids = rng.standard_normal((B, H, W)).astype(dtype)
    pts = rng.uniform(lo, hi, (B, Q, 2)).astype(dtype)
    return grids, pts


def both(fn_t, fn_j, *arrays):
    """``fn_t`` on torch tensors and ``fn_j`` on JAX arrays of the same
    numpy inputs, as numpy."""
    got = fn_t(*(torch.from_numpy(a) for a in arrays))
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    return got.numpy(), np.asarray(want)


def host_double(pts, grids):
    """The 4-term bilinear formula in numpy float64
    (tests/test_interp_pallas.py:191-203)."""
    g = np.asarray(grids, np.float64)
    p = np.asarray(pts, np.float64)
    B, H, W = g.shape
    r = np.clip(p[..., 0], 0, H - 1.0)
    c = np.clip(p[..., 1], 0, W - 1.0)
    r0 = np.clip(np.floor(r).astype(int), 0, H - 2)
    c0 = np.clip(np.floor(c).astype(int), 0, W - 2)
    tr, tc = r - r0, c - c0
    bi = np.arange(B)[:, None]
    return ((1 - tr) * (1 - tc) * g[bi, r0, c0]
            + (1 - tr) * tc * g[bi, r0, c0 + 1]
            + tr * (1 - tc) * g[bi, r0 + 1, c0]
            + tr * tc * g[bi, r0 + 1, c0 + 1])


# ------------------------------------------- plain functions vs JAX

DTYPES = ["float32", "float64"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_lerp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    a, b, t = (rng.standard_normal(1001).astype(dtype) for _ in range(3))
    got, want = both(interp.lerp, jinterp.lerp, a, b, t)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_interp1d_matches_jax(dtype):
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(-3, 3, 999)).astype(dtype)
    fp = np.sin(xp).astype(dtype)
    xq = rng.uniform(-3.5, 3.5, (37, 81)).astype(dtype)   # out of range too
    got, want = both(lambda q, x, f: interp.interp1d(q, x, f),
                     jinterp.interp1d, xq, xp, fp)
    assert got.shape == xq.shape and got.dtype == xq.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_lerp_uniform_matches_jax(dtype):
    n, x0 = 1001, -3.0
    dx = 6.0 / (n - 1)
    rng = np.random.default_rng(2)
    fp = np.sin(x0 + dx * np.arange(n)).astype(dtype)
    xq = rng.uniform(-3.5, 3.5, 5003).astype(dtype)
    got, want = both(lambda q, f: interp.lerp_uniform(q, f, x0, dx),
                     lambda q, f: jinterp.lerp_uniform(q, f, x0, dx), xq, fp)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bilinear_matches_jax(dtype):
    rng = np.random.default_rng(3)
    grid = rng.standard_normal((33, 47)).astype(dtype)
    pts = rng.uniform(-2, 50, (5, 61, 2)).astype(dtype)
    got, want = both(interp.bilinear, jinterp.bilinear, pts, grid)
    assert got.shape == (5, 61)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bilinear_batched_matches_jax(dtype):
    grids, pts = grids_pts(5, 3, 17, 29, 257, -2.0, 31.0, dtype)
    got, want = both(interp.bilinear_batched, jinterp.bilinear_batched,
                     pts, grids)
    assert got.shape == (3, 257)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype])


# ------------------------------- entry points vs the Pallas kernels

# (method, B, H, W, Q, query range) of tests/test_interp_pallas.py
PALLAS_CASES = {
    "full_64x128": ("auto", 2, 64, 128, 1501, -3.0, 67.0),
    "unaligned_100x100": ("auto", 2, 100, 100, 333, -2.0, 102.0),
    "binned_300x260": ("binned", 2, 300, 260, 9000, -3.0, 303.0),
    "one_bin_256": ("binned", 1, 256, 256, 4096, 40.0, 41.0),
    "single_bin_grid_64x96": ("binned", 1, 64, 96, 2000, -2.0, 66.0),
    "auto_700x650": ("auto", 1, 700, 650, 5000, 0.0, 699.0),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_bilinear_batched_matches_pallas(interpret, case):
    method, B, H, W, Q, lo, hi = PALLAS_CASES[case]
    grids, pts = grids_pts(list(PALLAS_CASES).index(case), B, H, W, Q, lo,
                           hi)
    got, want = both(
        lambda p, g: interp_cuda.bilinear_batched(p, g, method=method),
        lambda p, g: interp_pallas.bilinear_batched(p, g, method=method),
        pts, grids)
    assert got.shape == (B, Q) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PALLAS_ATOL)
    # the port is exact f32: it agrees with the XLA reference to rounding
    exact = np.asarray(jinterp.bilinear_batched(jnp.asarray(pts),
                                                jnp.asarray(grids)))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    # both methods are the same function, bit for bit
    other = "full" if interp_cuda._auto_bilinear_method(H, W) == "binned" \
        else "binned"
    alt = interp_cuda.bilinear_batched(torch.from_numpy(pts),
                                       torch.from_numpy(grids), method=other)
    np.testing.assert_array_equal(alt.numpy(), got)


@pytest.mark.parametrize("method", ["full", "binned"])
def test_bf16_mode_reads_the_masked_grid(method):
    grids, pts = grids_pts(7, 2, 64, 128, 1024, -1.0, 65.0)
    p, g = torch.from_numpy(pts), torch.from_numpy(grids)
    got = interp_cuda.bilinear_batched(p, g, precision="bf16",
                                       method=method).numpy()
    exact = np.asarray(jinterp.bilinear_batched(jnp.asarray(pts),
                                                jnp.asarray(grids)))
    assert np.abs(got - exact).max() < BF16_BAR
    # the grid's top 16 bits, as the JAX package masks its high part
    hi = (grids.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    masked = np.asarray(jinterp.bilinear_batched(jnp.asarray(pts),
                                                 jnp.asarray(hi)))
    np.testing.assert_allclose(got, masked, rtol=0, atol=1e-6)


def test_bf16_mode_against_pallas_bf16(interpret):
    grids, pts = grids_pts(8, 1, 64, 128, 1024, 0.0, 63.0)
    got, want = both(
        lambda p, g: interp_cuda.bilinear_batched(p, g, precision="bf16"),
        lambda p, g: interp_pallas.bilinear_batched(p, g, precision="bf16"),
        pts, grids)
    # the TPU kernel also rounds its weights to bf16; the port keeps f32
    assert np.abs(got - want).max() < BF16_BAR


def test_result_takes_the_grid_dtype(interpret):
    grids, pts = grids_pts(9, 1, 40, 50, 300, -1.0, 52.0, np.float64)
    got, want = both(interp_cuda.bilinear_batched,
                     interp_pallas.bilinear_batched, pts, grids)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=PALLAS_ATOL)


# ---------------------------------------------------------------- f64

@pytest.mark.parametrize("in_dtype", [np.float64, np.float32])
def test_bilinear_f64_matches_host_double_and_pallas(interpret, in_dtype):
    grids, pts = grids_pts(21, 2, 64, 96, 701, -1.0, 65.0, in_dtype)
    got, want = both(interp_cuda.bilinear_batched_f64,
                     interp_pallas.bilinear_batched_f64, pts, grids)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, host_double(pts, grids), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


# the bench's f64 leg cut to 2 grids; odd W; one query
@pytest.mark.parametrize("shape", [(2, 256, 256, 2048), (3, 33, 7, 501),
                                   (2, 9, 3, 1)])
def test_bilinear_f64_shapes_match_pallas(interpret, shape):
    B, H, W, Q = shape
    grids, pts = grids_pts(22, B, H, W, Q, -2.0, max(H, W) + 2.0, np.float64)
    got, want = both(interp_cuda.bilinear_batched_f64,
                     interp_pallas.bilinear_batched_f64, pts, grids)
    assert got.shape == (B, Q) and got.dtype == np.float64
    np.testing.assert_allclose(got, host_double(pts, grids), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


def test_f64_launch_test_never_takes_cpu_tensors():
    """The entry's one-test path to the launch answers only for CUDA
    tensors: CPU tensors, of any dtype or layout, take the full checks and
    the plain version."""
    p64, g64 = torch.zeros(2, 5, 2, dtype=torch.float64), torch.zeros(
        2, 4, 6, dtype=torch.float64)
    assert interp_cuda._f64_dims(p64, g64) is None
    assert interp_cuda._f64_dims(p64.to("meta"), g64.to("meta")) is None
    before = dict(interp_cuda.LAUNCHES)
    out = interp_cuda.bilinear_batched_f64(p64, g64)
    assert out.shape == (2, 5) and out.dtype == torch.float64
    assert interp_cuda.LAUNCHES == before


def test_bilinear_f64_rejects_oversized_grid_as_jax_does():
    pts = np.zeros((1, 4, 2))
    grids = np.zeros((1, 512, 256))
    with pytest.raises(ValueError, match="grid too large"):
        interp_pallas.bilinear_batched_f64(jnp.asarray(pts),
                                           jnp.asarray(grids))
    with pytest.raises(ValueError, match="grid too large"):
        interp_cuda.bilinear_batched_f64(torch.from_numpy(pts),
                                         torch.from_numpy(grids))
    # the largest grid both take
    ok = interp_cuda.bilinear_batched_f64(torch.zeros(1, 4, 2),
                                          torch.zeros(1, 256, 256))
    assert ok.shape == (1, 4)


# ------------------------------------------------------------ binning

BIN_CASES = {
    # uniform over the grid, out-of-range queries included
    "uniform": (1, 300, 260, 9000, -3.0, 303.0),
    # every query in one bin
    "one_bin": (2, 256, 256, 4096, 40.0, 41.0),
    # queries in the first rows and columns only: most bins stay empty
    "empty_bins": (2, 700, 650, 3001, 0.0, 100.0),
    # a grid smaller than one bin
    "single_bin_grid": (1, 64, 96, 2000, -2.0, 66.0),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binning_groups_every_query_once(case):
    B, H, W, Q, lo, hi = BIN_CASES[case]
    pts = np.random.default_rng(11).uniform(lo, hi, (B, Q, 2)).astype(
        np.float32)
    bins = interp_cuda.bin_queries(torch.from_numpy(pts), H, W)
    nbr, nbc, be_r, be_c = interp_cuda.bin_layout(H, W)
    assert max(be_r, be_c) <= 120 and bins.nbins == nbr * nbc
    assert (nbr - 1) * be_r <= H - 2 and (nbc - 1) * be_c <= W - 2
    order = bins.order.numpy()
    offsets = bins.offsets.numpy()
    assert bins.order.dtype == bins.offsets.dtype == torch.int32
    assert offsets.shape == (B, bins.nbins + 1)
    # the pairs in bin order are the queries' own
    np.testing.assert_array_equal(
        bins.pairs.numpy(), np.take_along_axis(pts, order[..., None].astype(
            np.int64), axis=1))
    r0 = np.clip(np.floor(np.clip(pts[..., 0], 0, H - 1)), 0, H - 2)
    c0 = np.clip(np.floor(np.clip(pts[..., 1], 0, W - 1)), 0, W - 2)
    for b in range(B):
        np.testing.assert_array_equal(np.sort(order[b]), np.arange(Q))
        assert offsets[b, 0] == 0 and offsets[b, -1] == Q
        assert (np.diff(offsets[b]) >= 0).all()
        for k in range(bins.nbins):
            ids = order[b, offsets[b, k]:offsets[b, k + 1]]
            rb, cb = (k // nbc) * be_r, (k % nbc) * be_c
            # each query's corner lies in its bin
            assert ((r0[b, ids] >= rb) & (r0[b, ids] < rb + be_r)).all()
            assert ((c0[b, ids] >= cb) & (c0[b, ids] < cb + be_c)).all()
    counts = np.diff(offsets, axis=1)
    if case == "one_bin":
        assert (counts.max(axis=1) == Q).all()
    if case == "empty_bins":
        assert (counts == 0).sum() > bins.nbins


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binning_matches_the_jax_bin_assignment(case):
    """The plain binning against the JAX binned path's own bin assignment
    and offsets (interp_pallas.py:779-794), recomputed from the same
    pairs."""
    B, H, W, Q, lo, hi = BIN_CASES[case]
    pts = np.random.default_rng(13).uniform(lo, hi, (B, Q, 2)).astype(
        np.float32)
    bins = interp_cuda.bin_queries(torch.from_numpy(pts), H, W)
    nbr, nbc, be_r, be_c = interp_cuda.bin_layout(H, W)
    nbins = nbr * nbc
    # interp_pallas.py:779-784
    r = jnp.clip(jnp.asarray(pts)[..., 0], 0.0, H - 1.0)
    c = jnp.clip(jnp.asarray(pts)[..., 1], 0.0, W - 1.0)
    r0 = jnp.clip(r.astype(jnp.int32), 0, H - 2)
    c0 = jnp.clip(c.astype(jnp.int32), 0, W - 2)
    bin_id = (jnp.minimum(r0 // be_r, nbr - 1) * nbc
              + jnp.minimum(c0 // be_c, nbc - 1))
    # :785-794, the sorted keys and the searchsorted offsets
    bits = max(1, (Q - 1).bit_length())
    key = (bin_id << bits) | jnp.arange(Q, dtype=jnp.int32)
    key_s = jnp.sort(key, axis=1)
    edges = jnp.arange(nbins + 1, dtype=jnp.int32) << bits
    want = np.stack([np.searchsorted(np.asarray(row), np.asarray(edges),
                                     side="left") for row in key_s])
    np.testing.assert_array_equal(bins.offsets.numpy(), want)
    # every query lands in the JAX bin
    got_bin = np.empty((B, Q), np.int64)
    order, offsets = bins.order.numpy(), bins.offsets.numpy()
    for b in range(B):
        for k in range(nbins):
            got_bin[b, order[b, offsets[b, k]:offsets[b, k + 1]]] = k
    np.testing.assert_array_equal(got_bin, np.asarray(bin_id))


def test_binned_plain_is_the_full_gather_bit_for_bit():
    grids, pts = grids_pts(12, 2, 700, 650, 3001, -3.0, 703.0)
    p, g = torch.from_numpy(pts), torch.from_numpy(grids)
    bins = interp_cuda.bin_queries(p, 700, 650)
    assert torch.equal(interp_cuda.binned_plain(g, bins),
                       interp_cuda.gather_plain(p, g))


def test_auto_method_is_the_jax_rule():
    sizes = [2, 3, 100, 127, 128, 129, 255, 256, 257, 384, 512, 513, 700,
             1024]
    for h in sizes:
        for w in sizes:
            assert (interp_cuda._auto_bilinear_method(h, w)
                    == interp_pallas._auto_bilinear_method(h, w)), (h, w)
    assert interp_cuda._auto_bilinear_method(256, 256) == "full"
    assert interp_cuda._auto_bilinear_method(1024, 1024) == "binned"


# -------------------------------------------------------- rejections

def test_entry_points_reject_what_they_do_not_take():
    p = torch.zeros(2, 5, 2)
    g = torch.zeros(2, 4, 6)
    fns = (interp_cuda.bilinear_batched, interp_cuda.bilinear_batched_f64)
    for fn in fns:
        with pytest.raises(ValueError, match=r"\(B, Q, 2\)"):
            fn(torch.zeros(2, 5, 3), g)
        with pytest.raises(ValueError, match=r"\(B, Q, 2\)"):
            fn(p[:1], g)
        with pytest.raises(ValueError, match="H >= 2"):
            fn(p, torch.zeros(2, 1, 6))
        with pytest.raises(TypeError, match="floating"):
            fn(p, g.int())
        with pytest.raises(ValueError, match="one device"):
            fn(p, g.to("meta"))
        with pytest.raises(ValueError, match="CUDA"):
            fn(p.to("meta"), g.to("meta"))
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.zeros(2, 2, 5).transpose(1, 2), g)
    with pytest.raises(ValueError, match="precision"):
        interp_cuda.bilinear_batched(p, g, precision="fp32")
    with pytest.raises(ValueError, match="method"):
        interp_cuda.bilinear_batched(p, g, method="mxu")


def test_kernel_wrappers_refuse_cpu_tensors():
    p, g = torch.zeros(1, 5, 2), torch.zeros(1, 4, 6)
    bins = interp_cuda.bin_queries(p, 4, 6)
    before = dict(interp_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.gather_cuda(p, g)
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.binned_cuda(g, bins)
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.bin_queries_cuda(p, 4, 6)
    with pytest.raises(ValueError, match="CUDA"):
        interp_cuda.f64_cuda(p.double(), g.double())
    # the CPU path runs the plain versions and launches nothing
    pt.bilinear_batched(p, g, method="binned")
    pt.bilinear_batched_f64(p, g)
    assert interp_cuda.LAUNCHES == before
