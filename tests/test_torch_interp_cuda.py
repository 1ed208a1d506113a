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
# of the bin edge
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


@pytest.mark.parametrize("precision", ["bf16x2", "bf16"])
@pytest.mark.parametrize("case", list(BINNED_CASES))
def test_binned_kernel_matches_plain(card, case, precision):
    B, H, W, Q, lo, hi = BINNED_CASES[case]
    pts, grids = inputs(card, B, H, W, Q, lo, hi)
    g = grids if precision == "bf16x2" else ic.bf16_grid(grids)
    bins = ic.bin_queries(pts, H, W)
    before = ic.LAUNCHES["bilinear_binned"]
    got = ic.binned_cuda(pts, g, bins)
    torch.cuda.synchronize()
    assert ic.LAUNCHES["bilinear_binned"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert max_diff(got, ic.binned_plain(pts, g, bins)) <= F32_BAR
    assert max_diff(got, ic.gather_plain(pts, g)) <= F32_BAR


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
    bins = ic.bin_queries(pts, 40, 40)
    for got in (ic.gather_cuda(pts, grids), ic.binned_cuda(pts, grids, bins)):
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
