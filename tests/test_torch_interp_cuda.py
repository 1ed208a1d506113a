"""The 2-D bilinear kernels on the card, against their plain PyTorch
versions on the same CUDA tensors.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_interp_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.ops import interp_cuda as ic

pytestmark = pytest.mark.cuda

# same operation order and no fused multiply-adds: the kernels are expected
# to reproduce their plain versions exactly; these are the bars
# chip_smoke.py holds them to
F32_BAR = 1e-6
F64_BAR = 1e-13
BF16_BAR = 0.05


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the interpolation kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def inputs(card, B, H, W, Q, lo=-3.0, hi=None, dtype=torch.float32, seed=0):
    """Seeded normal grids and uniform queries in ``[lo, hi)`` (default
    ``[-3, max(H, W) + 3)``: out-of-range on both sides), on the card."""
    rng = np.random.default_rng(seed)
    hi = max(H, W) + 3.0 if hi is None else hi
    grids = torch.tensor(rng.standard_normal((B, H, W)), dtype=dtype,
                         device=card)
    pts = torch.tensor(rng.uniform(lo, hi, (B, Q, 2)), dtype=dtype,
                       device=card)
    return pts, grids


def max_diff(a, b):
    return float((a.double() - b.double()).abs().max())


# Q not a multiple of the 256-thread block, H and W not multiples of 32 or
# of the bin edge (all take the direct body: too few grids for staging)
GATHER_SHAPES = [(1, 2, 2, 1), (3, 37, 45, 1000), (2, 256, 256, 16384),
                 (1, 1024, 1024, 4099)]


@pytest.mark.parametrize("precision", ["bf16x2", "bf16"])
@pytest.mark.parametrize("B, H, W, Q", GATHER_SHAPES)
def test_gather_kernel_matches_plain(card, B, H, W, Q, precision):
    pts, grids = inputs(card, B, H, W, Q)
    g = grids if precision == "bf16x2" else ic.bf16_grid(grids)
    before = ic.LAUNCHES["bilinear_gather"]
    got = ic.gather_cuda(pts, g)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["bilinear_gather"] == before + 1
    assert got.shape == (B, Q) and bool(torch.isfinite(got).all())
    assert max_diff(got, ic.gather_plain(pts, g)) <= F32_BAR


BINNED_CASES = {
    "binned_300x260": (2, 300, 260, 9000, -3.0, None),
    "odd_130x250": (1, 130, 250, 777, -3.0, None),
    "single_bin_grid_64x96": (1, 64, 96, 2000, -2.0, None),
    # all queries in one bin
    "one_bin_256": (1, 256, 256, 4096, 40.0, 41.0),
    # 115 x 115 f32 windows: 52.9 KB of opt-in shared memory
    "large_1024": (2, 1024, 1024, 20011, -3.0, None),
}


@pytest.mark.parametrize("case", list(BINNED_CASES))
def test_device_binning_matches_plain_binning(card, case):
    B, H, W, Q, lo, hi = BINNED_CASES[case]
    pts, _ = inputs(card, B, H, W, Q, lo, hi)
    before = ic.LAUNCHES["bilinear_binning"]
    got = ic.bin_queries_cuda(pts, H, W)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["bilinear_binning"] == before + 1
    want = ic.bin_queries(pts, H, W)
    assert torch.equal(got.offsets, want.offsets)
    assert (got.nbc, got.be_r, got.be_c) == (want.nbc, want.be_r, want.be_c)
    offsets = want.offsets.cpu()
    for b in range(B):
        for k in range(want.nbins):
            lo_k, hi_k = int(offsets[b, k]), int(offsets[b, k + 1])
            ids = got.order[b, lo_k:hi_k]
            assert torch.equal(torch.sort(ids).values,
                               torch.sort(want.order[b, lo_k:hi_k]).values)
            # each id's pair travels with it
            assert torch.equal(got.pairs[b, lo_k:hi_k], pts[b, ids.long()])


@pytest.mark.parametrize("precision", ["bf16x2", "bf16"])
@pytest.mark.parametrize("case", list(BINNED_CASES))
def test_binned_kernel_matches_plain(card, case, precision):
    B, H, W, Q, lo, hi = BINNED_CASES[case]
    pts, grids = inputs(card, B, H, W, Q, lo, hi)
    g = grids if precision == "bf16x2" else ic.bf16_grid(grids)
    bins = ic.bin_queries_cuda(pts, H, W)
    before = ic.LAUNCHES["bilinear_binned"]
    bodies = dict(ic.BODIES)
    got = ic.binned_cuda(g, bins)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["bilinear_binned"] == before + 1
    copy = W * g.element_size() % 16 == 0
    key = "binned_async" if copy else "binned_sync"
    assert ic.BODIES[key] == bodies[key] + 1
    assert bool(torch.isfinite(got).all())
    assert max_diff(got, ic.binned_plain(g, bins)) <= F32_BAR
    assert max_diff(got, ic.gather_plain(pts, g)) <= F32_BAR
    # the plain binning's order gives the same result
    assert max_diff(ic.binned_cuda(g, ic.bin_queries(pts, H, W)), got) == 0.0


# (B, H, W, Q, grid dtype, bands the route gives the staged body (0: the
# direct body), the fewest bands that fit shared memory (0: none))
STAGED_CASES = {
    "bf16_256_one_band": (64, 256, 256, 3000, "bf16", 1, 1),
    "f32_256_two_bands": (64, 256, 256, 3001, "f32", 2, 2),
    # queries split into parts to reach every SM; W not a multiple of 4:
    # bands off the 16-byte boundaries
    "f32_300x259_parts": (16, 300, 259, 1001, "f32", 2, 2),
    # too few grids for staging to pay: routed to the direct body
    "f32_256_few_grids": (8, 256, 256, 5001, "f32", 0, 2),
    # the most bands: the route takes the direct body, staging still runs
    "f32_440x1024_eight_bands": (1, 440, 1024, 7001, "f32", 0, 8),
    # one row more than 8 bands hold: no staging at all
    "f32_441x1024_no_fit": (1, 441, 1024, 3000, "f32", 0, 0),
}


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_staged_gather_matches_plain_and_direct(card, case):
    B, H, W, Q, dtype, route, fit = STAGED_CASES[case]
    pts, grids = inputs(card, B, H, W, Q, seed=5)
    pts[0, ::11, 0] = float("nan")
    g = grids if dtype == "f32" else ic.bf16_grid(grids)
    assert ic.gather_body(pts, g) == route
    assert ic.staged_bands(H, W, g.element_size()) == fit
    bodies = dict(ic.BODIES)
    got = ic.gather_cuda(pts, g)
    torch.cuda.synchronize()
    key = "gather_staged" if route else "gather_direct"
    assert ic.BODIES[key] == bodies[key] + 1
    want = ic.gather_plain(pts, g)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert max_diff(got[ok], want[ok]) <= F32_BAR
    for body in ("direct", "staged"):
        if body == "staged" and fit == 0:
            with pytest.raises(ValueError, match="bands"):
                ic.gather_cuda(pts, g, body=body)
            continue
        other = ic.gather_cuda(pts, g, body=body)
        assert torch.equal(torch.isnan(other), torch.isnan(got))
        assert max_diff(other[ok], got[ok]) == 0.0


@pytest.mark.parametrize("method", ["full", "binned"])
def test_bf16_mode_is_bf16_grade(card, method):
    pts, grids = inputs(card, 2, 300, 260, 5000)
    exact = pt.bilinear_batched(pts, grids, method=method)
    coarse = pt.bilinear_batched(pts, grids, precision="bf16", method=method)
    assert 0.0 < max_diff(coarse, exact) < BF16_BAR


def host_double(pts, grids):
    """The 4-term bilinear formula in numpy float64."""
    g = grids.cpu().double().numpy()
    p = pts.cpu().double().numpy()
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


@pytest.mark.parametrize("B, H, W, Q", [(2, 64, 96, 701), (1, 2, 2, 3),
                                        (3, 255, 257, 1000)])
def test_f64_kernel_matches_plain_and_host_double(card, B, H, W, Q):
    pts, grids = inputs(card, B, H, W, Q, dtype=torch.float64)
    before = ic.LAUNCHES["bilinear_f64"]
    got = pt.bilinear_batched_f64(pts, grids)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["bilinear_f64"] == before + 1
    assert got.dtype == torch.float64 and got.shape == (B, Q)
    assert max_diff(got, ic.f64_plain(pts, grids)) <= F64_BAR
    np.testing.assert_allclose(got.cpu().numpy(), host_double(pts, grids),
                               rtol=0, atol=F64_BAR)


def test_more_than_65535_grids(card):
    """B = 65536 small grids, more than one launch dimension holds: both K7
    bodies, the device binning and K8, and K6, against the plain
    versions."""
    B, H, W, Q = 65536, 6, 9, 5
    pts, grids = inputs(card, B, H, W, Q)
    want = ic.gather_plain(pts, grids)
    for body in ("direct", "staged"):
        assert max_diff(ic.gather_cuda(pts, grids, body=body), want) <= F32_BAR
    bins = ic.bin_queries_cuda(pts, H, W)
    plain_bins = ic.bin_queries(pts, H, W)
    assert torch.equal(bins.offsets, plain_bins.offsets)
    assert max_diff(ic.binned_cuda(grids, bins), want) <= F32_BAR
    assert max_diff(pt.bilinear_batched(pts, grids, method="binned"),
                    want) <= F32_BAR
    pts64, grids64 = inputs(card, B, H, W, Q, dtype=torch.float64)
    assert max_diff(pt.bilinear_batched_f64(pts64, grids64),
                    ic.f64_plain(pts64, grids64)) <= F64_BAR


def test_auto_routes_by_grid_size(card):
    counts = dict(ic.LAUNCHES)
    small = pt.bilinear_batched(*inputs(card, 2, 256, 256, 1000))
    assert ic.LAUNCHES["bilinear_gather"] == counts["bilinear_gather"] + 1
    large = pt.bilinear_batched(*inputs(card, 1, 1024, 1024, 1000))
    assert ic.LAUNCHES["bilinear_binned"] == counts["bilinear_binned"] + 1
    assert ic.LAUNCHES["bilinear_gather"] == counts["bilinear_gather"] + 1
    assert small.shape == (2, 1000) and large.shape == (1, 1000)


def test_result_takes_the_grid_dtype(card):
    pts, grids = inputs(card, 2, 50, 60, 333, dtype=torch.float64)
    out = pt.bilinear_batched(pts, grids)
    assert out.dtype == torch.float64
    want = ic.gather_plain(pts.float(), grids.float()).double()
    assert max_diff(out, want) <= F32_BAR


def test_nan_queries_give_nan_like_the_plain_version(card):
    pts, grids = inputs(card, 1, 40, 40, 300)
    pts[0, ::7, 0] = float("nan")
    bins = ic.bin_queries_cuda(pts, 40, 40)
    for got in (ic.gather_cuda(pts, grids), ic.gather_cuda(pts, grids, "direct"),
                ic.binned_cuda(grids, bins)):
        want = ic.gather_plain(pts, grids)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert max_diff(got[ok], want[ok]) <= F32_BAR


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    pts, grids = inputs(card, 2, 20, 30, 100)
    with pytest.raises(TypeError):
        ic.gather_cuda(pts.double(), grids)
    with pytest.raises(ValueError, match="contiguous"):
        ic.gather_cuda(pts, grids.transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        ic.gather_cuda(pts, grids.cpu())
    # contiguous, but the (row, col) pairs sit off their 8-byte boundary:
    # the kernel refuses the vector load and the wrapper raises
    flat = torch.zeros(2 * 100 * 2 + 1, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ic.gather_cuda(flat[1:].view(2, 100, 2), grids)
