"""The 1-D interpolation kernels on the card, against their plain PyTorch
versions on the same CUDA tensors.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_interp1d_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.ops import interp1d_cuda as i1

pytestmark = pytest.mark.cuda

# same operation order and no fused multiply-adds: the kernels are expected
# to reproduce their plain versions exactly; this is the bar chip_smoke.py
# holds them to
BAR = 1e-6
EXTREME = [1e30, -1e30, 1e12, -1e12, float("inf"), float("-inf"),
           float("nan")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the interpolation kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def queries(card, Q, lo, hi, seed=0, extreme=True):
    """Seeded uniform queries in ``[lo, hi)``, the extreme values first."""
    q = np.random.default_rng(seed).uniform(lo, hi, Q)
    if extreme:
        q[:len(EXTREME)] = EXTREME
    return torch.tensor(q, dtype=torch.float32, device=card)


def same(got, want):
    """NaN where the plain version has NaN, within ``BAR`` elsewhere."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    if bool(ok.any()):
        assert float((got[ok] - want[ok]).abs().max()) <= BAR


def sin_table(card, n):
    fp = torch.tensor(np.sin(np.linspace(-3, 3, n)), dtype=torch.float32,
                      device=card)
    return fp, *i1.uniform_lims(-3.0, 6.0 / (n - 1))


def launched(key, fn):
    before = dict(i1.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    want = dict(before)
    want[key] += 1
    assert i1.LAUNCHES == want
    return out


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("n, Q", [(2, 1), (129, 1000), (1000, 100003),
                                  (65536, 70001)])
def test_lerp1d_kernel_matches_plain(card, n, Q):
    fp, x0, inv_dx = sin_table(card, n)
    q = queries(card, Q, -3.5, 3.5, extreme=Q >= len(EXTREME))
    got = launched("lerp1d", lambda: i1.lerp1d_cuda(q, fp, x0, inv_dx))
    same(got, i1.lerp1d_plain(q, fp, x0, inv_dx))


# ------------------------------------------------------------------ K4

K4_CASES = {
    # 2M uniform queries on 64k nodes: the bench's shape, one CTA a batch
    "bench_64k": (65536, 2_097_152, 512, -3.0, 3.0, "uniform"),
    # out-of-range and extreme queries, padded last batch
    "pads_and_extremes": (16384, 70001, 16, -3.5, 3.5, "uniform"),
    # one batch of 1000 queries spread over the whole table
    "one_sparse_batch": (65536, 1000, 1, -3.0, 3.0, "uniform"),
    # every query in a few cells
    "one_group": (65536, 200, 1, 0.5, 0.51, "uniform"),
    # clustered: normal around one node, 1% of the table's width
    "clustered": (65536, 300_001, 64, -3.0, 3.0, "clustered"),
    # queries already in ascending order
    "already_sorted": (4096, 300_001, 64, -3.2, 3.2, "sorted"),
    # batches above the staged size take the grid-stride body
    "large_batches": (65536, 100_003, 4, -3.5, 3.5, "uniform"),
    # more batches than one launch dimension holds (65535)
    "70000_batches": (1000, 140_001, 70_000, -3.5, 3.5, "uniform"),
}


def k4_queries(card, Q, lo, hi, dist):
    if dist == "clustered":
        q = np.random.default_rng(1).normal(lo + 0.37 * (hi - lo),
                                            0.01 * (hi - lo), Q)
        q[:len(EXTREME)] = EXTREME
        return torch.tensor(q, dtype=torch.float32, device=card)
    q = queries(card, Q, lo, hi)
    return torch.sort(q).values if dist == "sorted" else q


@pytest.mark.parametrize("case", list(K4_CASES))
def test_lerp1d_sorted_kernel_matches_plain(card, case):
    n, Q, nb, lo, hi, dist = K4_CASES[case]
    fp, x0, inv_dx = sin_table(card, n)
    q = k4_queries(card, Q, lo, hi, dist)
    qs, order = i1.sort_batches(q, nb)
    got = launched("lerp1d_sorted", lambda: i1.lerp1d_sorted_cuda(
        qs, order, fp, x0, inv_dx, Q, nb))
    same(got, i1.lerp1d_sorted_plain(qs, order, fp, x0, inv_dx, Q))
    # the same function as K3
    same(got, i1.lerp1d_plain(q, fp, x0, inv_dx))


@pytest.mark.parametrize("layout", ["global_sort", "two_batches_swapped",
                                    "global_sort_large_batches"])
def test_lerp1d_sorted_kernel_takes_any_permutation(card, layout):
    """Orders that sort_batches does not make: the whole padded query
    stream sorted at once (every batch holds ids of other batches), or
    two batches' rows exchanged (the others keep their own ids); in the
    staged body and, above its batch size, the grid-stride body."""
    nb = 4 if layout == "global_sort_large_batches" else 16
    Q = 100_003 if nb == 4 else 70_001
    fp, x0, inv_dx = sin_table(card, 16384)
    q = queries(card, Q, -3.5, 3.5)
    qs, order = i1.sort_batches(q, nb)
    if layout == "two_batches_swapped":
        qs, order = (x.view(nb, -1)[[1, 0, *range(2, nb)]].reshape(-1)
                     for x in (qs, order))
    else:
        qs, idx = torch.sort(qs)
        order = order[idx]
    got = launched("lerp1d_sorted", lambda: i1.lerp1d_sorted_cuda(
        qs, order, fp, x0, inv_dx, Q, nb))
    same(got, i1.lerp1d_sorted_plain(qs, order, fp, x0, inv_dx, Q))
    same(got, i1.lerp1d_plain(q, fp, x0, inv_dx))


def test_lerp1d_binned_with_more_than_65535_batches(card):
    fp, x0, inv_dx = sin_table(card, 1000)
    q = queries(card, 140_001, -3.5, 3.5)
    got = launched("lerp1d_sorted", lambda: pt.lerp1d_binned(
        q, fp, -3.0, 6.0 / 999, n_batches=70_000))
    same(got, i1.lerp1d_plain(q, fp, x0, inv_dx))


def test_lerp1d_takes_the_direct_kernel_on_large_tables(card):
    """The JAX package's rule would sort these; on the card K3 wins at
    every shape (tools/interp1d_route_study.py), with the same values as
    the sorted kernel."""
    fp, _, _ = sin_table(card, 65536)
    q = queries(card, 200_000, -3.2, 3.2)
    got = launched("lerp1d", lambda: pt.lerp1d(q, fp, -3.0, 6.0 / 65535))
    binned = launched("lerp1d_sorted", lambda: pt.lerp1d_binned(
        q, fp, -3.0, 6.0 / 65535, n_batches=64))
    same(got, binned)


# ------------------------------------------------------------------ K5

def nonuniform(card, n, g0=0.1, scale=0.05, seed=4):
    gaps = (g0 + np.random.default_rng(seed).uniform(0, 1, n - 1)).astype(
        np.float32)
    xp = np.concatenate([[0.0], np.cumsum(gaps)]).astype(np.float32)
    fp = np.sin(scale * xp).astype(np.float32)
    return (torch.tensor(xp, device=card), torch.tensor(fp, device=card))


def dense_cluster(card):
    xp = np.concatenate([np.linspace(0.0, 1.0, 50),
                         1.0 + np.linspace(1e-4, 2e-2, 100),
                         np.linspace(1.1, 10.0, 30)]).astype(np.float32)
    fp = np.random.default_rng(0).standard_normal(xp.shape[0]).astype(
        np.float32)
    return torch.tensor(xp, device=card), torch.tensor(fp, device=card)


@pytest.mark.parametrize("n, Q", [(2, 100), (129, 1000), (4096, 100003)])
def test_interp1d_kernel_matches_plain(card, n, Q):
    xp, fp = nonuniform(card, n)
    table = pt.make_interp1d(xp, fp)
    q = queries(card, Q, -1.0, float(xp[-1]) + 1.0)
    got = launched("interp1d", lambda: i1.interp1d_cuda(table, q))
    same(got, i1.interp1d_plain(table, q))


def test_interp1d_kernel_dense_cluster(card):
    table = pt.make_interp1d(*dense_cluster(card))
    q = queries(card, 7777, 0.9, 1.2)
    got = launched("interp1d", lambda: i1.interp1d_cuda(table, q))
    same(got, i1.interp1d_plain(table, q))


def test_interp1d_sorted_route_matches_plain(card):
    xp, fp = nonuniform(card, 2048, 0.05, 0.07, seed=14)
    table = pt.make_interp1d(xp, fp)
    q = queries(card, 262150, -1.0, float(xp[-1]) + 1.0)
    got = launched("interp1d", lambda: table(q, method="sorted"))
    same(got, launched("interp1d", lambda: table(q)))
    qs, order = i1.sort_batches(q, i1._pow2_batches(q.numel()))
    same(got, i1.interp1d_plain(table, qs, order, q.numel()))
    same(got, i1.interp1d_plain(table, q))


# ----------------------------------------------------- entry points

@pytest.mark.parametrize("fn", ["lerp1d", "lerp1d_binned", "interp1d"])
def test_empty_queries_launch_nothing(card, fn):
    fp, _, _ = sin_table(card, 300)
    xp = torch.linspace(-3, 3, 300, device=card)
    call = {"lerp1d": lambda q: pt.lerp1d(q, fp, -3.0, 6.0 / 299),
            "lerp1d_binned": lambda q: pt.lerp1d_binned(q, fp, -3.0,
                                                        6.0 / 299),
            "interp1d": lambda q: pt.make_interp1d(xp, fp)(q)}[fn]
    before = dict(i1.LAUNCHES)
    out = call(torch.empty(0, 4, dtype=torch.float64, device=card))
    assert out.shape == (0, 4) and out.dtype == torch.float64
    assert i1.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_results_take_the_query_dtype(card, dtype):
    fp, x0, inv_dx = sin_table(card, 1000)
    q = queries(card, 3000, -3.5, 3.5).to(dtype).view(30, 100)
    got = pt.lerp1d(q, fp, -3.0, 6.0 / 999)
    assert got.dtype == dtype and got.shape == (30, 100)
    want = i1.lerp1d_plain(q.float().reshape(-1), fp, x0, inv_dx)
    same(got.float().reshape(-1), want)
    xp, fpn = nonuniform(card, 500)
    got = pt.make_interp1d(xp, fpn)(q)
    assert got.dtype == dtype and got.shape == (30, 100)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    fp, x0, inv_dx = sin_table(card, 100)
    q = queries(card, 100, -3, 3)
    with pytest.raises(TypeError):
        i1.lerp1d_cuda(q.double(), fp, x0, inv_dx)
    with pytest.raises(ValueError, match="contiguous"):
        i1.lerp1d_cuda(q[::2], fp, x0, inv_dx)
    with pytest.raises(ValueError, match="one device|CUDA"):
        i1.lerp1d_cuda(q, fp.cpu(), x0, inv_dx)
    qs, order = i1.sort_batches(q, 8)
    with pytest.raises(ValueError, match="sort_batches"):
        i1.lerp1d_sorted_cuda(qs, order.int(), fp, x0, inv_dx, 100, 8)
