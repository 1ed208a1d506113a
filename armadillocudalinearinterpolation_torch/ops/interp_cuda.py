"""Batched 2-D bilinear interpolation on hand-written CUDA kernels
(``csrc/interp2d.cu``): the counterpart of the 2-D half of the JAX
package's ``ops/interp_pallas.py``.

Public entry points, with the JAX functions' contracts:

- :func:`bilinear_batched` ``(pts, grids, precision, method)``: f32
  compute, result in ``grids.dtype``.  ``method="full"`` runs the gather
  kernel (K7), ``"binned"`` the device binning and the bin-window kernel
  (K8), ``"auto"`` picks by grid size with the JAX package's rule
  (:func:`_auto_bilinear_method`).  ``precision="bf16x2"`` is exact f32;
  ``"bf16"`` reads the grid at bf16 precision (the top 16 bits of each f32,
  masked as the JAX package masks its high part) and blends in f32.
- :func:`bilinear_batched_f64` ``(pts, grids)``: native fp64 (K6), with the
  JAX package's ``MAX_TABLE`` limit on ``H*W``.  Contiguous float64 tensors
  on one card pass one test (:func:`_f64_dims`) and go straight to the
  launch; anything else takes the full checks and casts.

K7 has two bodies, chosen by shape before the launch (:func:`gather_body`):
the staged body copies each grid, in bands of rows, into the shared memory
of one or two CTAs (more where the queries are split into parts to reach
every SM) and gathers the corners there; the shapes where
that does not pay on the card take the direct body, which gathers from
device memory.  K8's windows
arrive by asynchronous 16-byte copies where the grid's rows are whole
multiples of 16 bytes, else by plain loads.

Each kernel has a plain PyTorch version beside it (:func:`gather_plain`,
:func:`bin_queries`, :func:`binned_plain`, :func:`f64_plain`).  CUDA
tensors launch the kernel, CPU tensors take the plain version, anything else
raises; nothing falls back.  ``LAUNCHES`` counts the launches of each kernel
wrapper by name, ``BODIES`` the launches of each body.  The tent weights,
bf16 hi/lo splits, hi/lo f32 tables, query sub-tiling and restore sort of
the TPU kernels are not carried over: the card gathers directly.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import _build
from .interp import bilinear_batched as _bilinear_plain
from .interp import bilinear_corners, blend

MAX_TABLE = 65536       # f64 grid nodes the JAX package's kernel accepts
_TILE = 128             # grid tile of the auto rule
_BIN_MAX_EDGE = 120     # bin extent of the binned path (JAX :667)
_HI_MASK = -65536       # 0xFFFF0000 as an int32: sign, exponent, 7 mantissa bits
# the staged K7 body: a band of rows plus one halo row per CTA, within an
# H100's opt-in shared memory per block (232448 bytes) less 16 bytes of
# alignment lead; at most 8 bands per grid
_STAGED_BAND_BYTES = 232448 - 16
_MAX_BANDS = 8
_MAX_PARTS = 8          # query parts per grid of the staged body
# where the staged body beat the direct one on the card (PERF.md, PR 5;
# 16384 queries per grid): at most 2 bands per grid and at least 16 grids
_STAGED_ROUTE_BANDS = 2
_STAGED_ROUTE_GRIDS = 16
_BIN_BLOCK = 2048       # queries per block of the binning kernels

LAUNCHES = {"bilinear_gather": 0, "bilinear_binning": 0,
            "bilinear_binned": 0, "bilinear_f64": 0}
BODIES = {"gather_staged": 0, "gather_direct": 0, "binned_async": 0,
          "binned_sync": 0}


def _auto_bilinear_method(h: int, w: int) -> str:
    """``method="auto"``: binned above 4 tiles of 128x128, else full.

    The JAX package's rule (``interp_pallas.py:902-923``), set by the TPU's
    crossover and compile envelope; kept unchanged on the card.
    """
    return ("binned" if (h + _TILE - 1) // _TILE * ((w + _TILE - 1) // _TILE)
            > 4 else "full")


def _check_inputs(fn: str, pts: torch.Tensor, grids: torch.Tensor):
    """Shapes, dtypes, devices and layout the public entry points take;
    returns ``(B, Q, H, W)``."""
    if (pts.ndim != 3 or pts.shape[2] != 2 or grids.ndim != 3
            or pts.shape[0] != grids.shape[0]):
        raise ValueError(f"{fn}: pts must be (B, Q, 2) and grids (B, H, W); "
                         f"got {tuple(pts.shape)} and {tuple(grids.shape)}")
    B, H, W = grids.shape
    if H < 2 or W < 2:
        raise ValueError(f"{fn}: grids need H >= 2 and W >= 2; got {H}x{W}")
    if not (pts.is_floating_point() and grids.is_floating_point()):
        raise TypeError(f"{fn}: pts and grids must be floating point; got "
                        f"{pts.dtype} and {grids.dtype}")
    if pts.device != grids.device:
        raise ValueError(f"{fn}: pts and grids must be on one device; got "
                         f"{pts.device} and {grids.device}")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: CUDA tensors run the kernel and CPU tensors "
                         f"its plain version; got {pts.device}")
    if not (pts.is_contiguous() and grids.is_contiguous()):
        raise ValueError(f"{fn}: pts and grids must be contiguous")
    return B, pts.shape[1], H, W


def bf16_grid(grids32: torch.Tensor) -> torch.Tensor:
    """The f32 grid at bf16 precision: the top 16 bits of each value
    (masked, not rounded), as a bfloat16 tensor of half the bytes."""
    return (grids32.view(torch.int32) >> 16).to(torch.int16).view(
        torch.bfloat16)


def staged_bands(h: int, w: int, itemsize: int) -> int:
    """Bands of the staged K7 body for an ``h x w`` grid of
    ``itemsize``-byte nodes: the fewest whose bands (``ceil(h / bands)``
    rows plus one halo row each) fit one CTA's shared memory; 0 if more
    than 8 would be needed."""
    for bands in range(1, min(_MAX_BANDS, h) + 1):
        if (-(-h // bands) + 1) * w * itemsize <= _STAGED_BAND_BYTES:
            return bands
    return 0


def gather_body(pts32: torch.Tensor, grid: torch.Tensor) -> int:
    """K7's body for these tensors, by shape: the staged body's band count
    where it beat the direct body on the card (at most 2 bands per grid and
    at least 16 grids), else 0, the direct body (also for pairs off their
    16-byte boundary)."""
    B, h, w = grid.shape
    bands = staged_bands(h, w, grid.element_size())
    if (pts32.data_ptr() % 16 or not 0 < bands <= _STAGED_ROUTE_BANDS
            or B < _STAGED_ROUTE_GRIDS):
        return 0
    return bands


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def staged_parts(B: int, bands: int, sms: int) -> int:
    """Query parts per grid of the staged body: enough CTAs (``B * bands *
    parts``) to reach every one of the card's ``sms`` SMs, at most 8."""
    return max(1, min(_MAX_PARTS, sms // (B * bands)))


# ------------------------------------------------------------- binning

@dataclasses.dataclass(frozen=True)
class Bins:
    """Queries grouped by grid bin, per grid.

    Bin ``k`` of grid ``b`` holds the queries
    ``order[b, offsets[b, k]:offsets[b, k + 1]]``, whose (row, col) pairs
    are ``pairs[b, offsets[b, k]:offsets[b, k + 1]]``; it covers corner rows
    ``[(k // nbc) * be_r, +be_r)`` and columns ``[(k % nbc) * be_c, +be_c)``,
    so its queries read the ``(be_r + 1) x (be_c + 1)`` nodes from there.
    The order inside a bin is not fixed.
    """
    order: torch.Tensor      # (B, Q) int32 query ids, bin by bin
    offsets: torch.Tensor    # (B, nbins + 1) int32
    pairs: torch.Tensor      # (B, Q, 2) f32 pairs, bin by bin
    nbc: int
    be_r: int
    be_c: int

    @property
    def nbins(self) -> int:
        return self.offsets.shape[1] - 1


def bin_layout(h: int, w: int):
    """``(nbr, nbc, be_r, be_c)``: bins per axis and their extents, at most
    120 corner rows or columns each, spread evenly (JAX :768-771)."""
    nbr = max(1, -(-max(h - 1, 1) // _BIN_MAX_EDGE))
    nbc = max(1, -(-max(w - 1, 1) // _BIN_MAX_EDGE))
    return nbr, nbc, -(-max(h - 1, 1) // nbr), -(-max(w - 1, 1) // nbc)


def bin_queries(pts32: torch.Tensor, h: int, w: int) -> Bins:
    """Plain version of the device binning: bin ids, per-bin counts
    (``bincount``), offsets (``cumsum``), the query order (stable
    ``argsort`` of the bin ids) and the pairs in that order."""
    B, Q, _ = pts32.shape
    nbr, nbc, be_r, be_c = bin_layout(h, w)
    nbins = nbr * nbc
    r = torch.clamp(pts32[..., 0], 0.0, h - 1.0)
    c = torch.clamp(pts32[..., 1], 0.0, w - 1.0)
    # truncation after the clip (JAX :781-782): r >= 0, so it is the floor
    r0 = torch.clamp(r.long(), 0, h - 2)
    c0 = torch.clamp(c.long(), 0, w - 2)
    bin_id = (torch.clamp(r0 // be_r, max=nbr - 1) * nbc
              + torch.clamp(c0 // be_c, max=nbc - 1))
    order = torch.argsort(bin_id, dim=1, stable=True)
    per_grid = bin_id + nbins * torch.arange(B, device=pts32.device)[:, None]
    counts = torch.bincount(per_grid.reshape(-1),
                            minlength=B * nbins).reshape(B, nbins)
    offsets = torch.cat([counts.new_zeros(B, 1), counts.cumsum(1)], dim=1)
    pairs = torch.gather(pts32, 1, order[..., None].expand(B, Q, 2))
    return Bins(order=order.int(), offsets=offsets.int(),
                pairs=pairs.contiguous(), nbc=nbc, be_r=be_r, be_c=be_c)


# ---------------------------------------------------- plain versions

def gather_plain(pts32: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather kernel: f32 bilinear of ``pts32
    (B, Q, 2)`` in ``grid (B, H, W)`` (f32, or the bf16 copy)."""
    return _bilinear_plain(pts32, grid.float())


def binned_plain(grid: torch.Tensor, bins: Bins) -> torch.Tensor:
    """Plain version of the bin-window kernel: each query, in bin order,
    reads its corners relative to its bin's window, and the result goes
    back to its query id."""
    p = bins.pairs
    B, Q, _ = p.shape
    _, h, w = grid.shape
    # bin of sorted position k: the number of bins that end at or before k
    k = torch.arange(Q, dtype=torch.int32, device=p.device).expand(
        B, Q).contiguous()
    bin_k = torch.searchsorted(bins.offsets[:, 1:].contiguous(), k,
                               right=True)
    rb = (bin_k // bins.nbc) * bins.be_r
    cb = (bin_k % bins.nbc) * bins.be_c
    r0, c0, tr, tc = bilinear_corners(p, h, w)
    lr = torch.clamp(r0 - rb, 0, bins.be_r - 1)
    lc = torch.clamp(c0 - cb, 0, bins.be_c - 1)
    vals = blend(grid.float().reshape(B, h * w), (rb + lr) * w + cb + lc, w,
                 tr, tc)
    return torch.empty_like(vals).scatter_(1, bins.order.long(), vals)


def f64_plain(pts64: torch.Tensor, grids64: torch.Tensor) -> torch.Tensor:
    """Plain version of the f64 kernel: bilinear in float64."""
    return _bilinear_plain(pts64, grids64)


# ------------------------------------------------------ kernel wrappers
#
# Each public wrapper checks its arguments and calls a private launcher;
# the entry points, which check and cast their inputs themselves, call the
# launchers directly, so that no call checks the same tensors twice.

def _check_kernel_args(fn: str, pts: torch.Tensor, grid: torch.Tensor,
                       pts_dtype, grid_dtypes) -> None:
    _check_inputs(fn, pts, grid)
    if pts.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors; got {pts.device} (the "
                         "plain version serves CPU tensors)")
    if pts.dtype != pts_dtype or grid.dtype not in grid_dtypes:
        raise TypeError(f"{fn}: pts must be {pts_dtype} and the grid one of "
                        f"{grid_dtypes}; got {pts.dtype} and {grid.dtype}")


def _launch(key: str, entry: str, dev: torch.device, *args) -> None:
    _build.launch(_build.entry(entry), f"{key} kernel launch", dev.index,
                  *args)
    LAUNCHES[key] += 1


def _gather(pts32: torch.Tensor, grid: torch.Tensor,
            body: str | None = None) -> torch.Tensor:
    B, Q, _ = pts32.shape
    _, H, W = grid.shape
    if body is None:
        bands = gather_body(pts32, grid)
    elif body == "direct":
        bands = 0
    elif body == "staged":
        bands = staged_bands(H, W, grid.element_size())
        if bands == 0:
            raise ValueError(f"gather_cuda: a {H}x{W} grid needs more than "
                             f"{_MAX_BANDS} bands of shared memory")
    else:
        raise ValueError(f"body must be None, 'staged' or 'direct'; got "
                         f"{body!r}")
    parts = staged_parts(B, bands, _sm_count(pts32.device.index)) \
        if bands else 1
    out = torch.empty(B, Q, dtype=torch.float32, device=pts32.device)
    _launch("bilinear_gather", "atorch_bilinear_gather", pts32.device,
            pts32.data_ptr(), grid.data_ptr(), out.data_ptr(), B, Q, H, W,
            int(grid.dtype == torch.bfloat16), bands, parts)
    BODIES["gather_staged" if bands else "gather_direct"] += 1
    return out


def gather_cuda(pts32: torch.Tensor, grid: torch.Tensor,
                body: str | None = None) -> torch.Tensor:
    """K7 on the card.  ``body``: ``None`` chooses by shape
    (:func:`gather_body`); ``"staged"`` (with the fewest bands that fit) or
    ``"direct"`` forces one, for timing the two against each other."""
    _check_kernel_args("gather_cuda", pts32, grid, torch.float32,
                       (torch.float32, torch.bfloat16))
    return _gather(pts32, grid, body)


def _bin(pts32: torch.Tensor, h: int, w: int) -> Bins:
    B, Q, _ = pts32.shape
    nbr, nbc, be_r, be_c = bin_layout(h, w)
    nbins = nbr * nbc
    nblk = -(-Q // _BIN_BLOCK)
    # one allocation: pairs (as int32 bit patterns), order, offsets, and the
    # per-block histograms the scan turns into slots
    sizes = (2 * B * Q, B * Q, B * (nbins + 1), B * nblk * nbins)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=pts32.device)
    pairs, order, offsets, hist = torch.split(buf, sizes)
    _launch("bilinear_binning", "atorch_bilinear_binning", pts32.device,
            pts32.data_ptr(), pairs.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), hist.data_ptr(), B, Q, h, w, nbr, nbc, be_r,
            be_c)
    return Bins(order=order.view(B, Q), offsets=offsets.view(B, nbins + 1),
                pairs=pairs.view(torch.float32).view(B, Q, 2), nbc=nbc,
                be_r=be_r, be_c=be_c)


def bin_queries_cuda(pts32: torch.Tensor, h: int, w: int) -> Bins:
    """The binning on the card (a counting sort in three kernels): the
    same counts and offsets as :func:`bin_queries`, and in each bin the
    same query ids, in an order that is not fixed."""
    if (pts32.ndim != 3 or pts32.shape[2] != 2 or pts32.dtype !=
            torch.float32 or pts32.device.type != "cuda"
            or not pts32.is_contiguous()):
        raise ValueError("bin_queries_cuda: pts must be a contiguous (B, Q, "
                         "2) float32 CUDA tensor")
    if h < 2 or w < 2:
        raise ValueError(f"bin_queries_cuda: grids need H >= 2 and W >= 2; "
                         f"got {h}x{w}")
    return _bin(pts32, h, w)


def _binned(grid: torch.Tensor, bins: Bins) -> torch.Tensor:
    B, Q, _ = bins.pairs.shape
    _, H, W = grid.shape
    # 16-byte cp.async window copies need 16-byte grid rows
    copy = grid.data_ptr() % 16 == 0 and W * grid.element_size() % 16 == 0
    out = torch.empty(B, Q, dtype=torch.float32, device=grid.device)
    _launch("bilinear_binned", "atorch_bilinear_binned", grid.device,
            grid.data_ptr(), bins.pairs.data_ptr(), bins.order.data_ptr(),
            bins.offsets.data_ptr(), out.data_ptr(), B, Q, H, W, bins.nbins,
            bins.nbc, bins.be_r, bins.be_c,
            int(grid.dtype == torch.bfloat16), int(copy))
    BODIES["binned_async" if copy else "binned_sync"] += 1
    return out


def binned_cuda(grid: torch.Tensor, bins: Bins) -> torch.Tensor:
    """K8 on the card: persistent CTAs over the (grid, bin) items, the next
    bin's window in flight while the current bin's queries are computed."""
    _check_kernel_args("binned_cuda", bins.pairs, grid, torch.float32,
                       (torch.float32, torch.bfloat16))
    B, Q, _ = bins.pairs.shape
    _, H, W = grid.shape
    order, offsets = bins.order, bins.offsets
    nbr, nbc, be_r, be_c = bin_layout(H, W)
    if (order.shape != (B, Q) or offsets.shape != (B, nbr * nbc + 1)
            or order.dtype != torch.int32 or offsets.dtype != torch.int32
            or order.device != grid.device or offsets.device != grid.device
            or not (order.is_contiguous() and offsets.is_contiguous())
            or (bins.nbc, bins.be_r, bins.be_c) != (nbc, be_r, be_c)):
        raise ValueError("binned_cuda: bins must come from bin_queries or "
                         "bin_queries_cuda for this grid's shape")
    return _binned(grid, bins)


def _f64_dims(pts: torch.Tensor, grids: torch.Tensor):
    """``(B, Q, H, W)`` where ``pts (B, Q, 2)`` and ``grids (B, H, W)``, H
    and W >= 2, are contiguous float64 tensors on one CUDA device: all that
    K6's launch needs, in one test of the common case; ``None`` otherwise
    (the full checks then name what is wrong)."""
    if (pts.dtype is torch.float64 and grids.dtype is torch.float64
            and pts.is_cuda and grids.is_cuda and pts.is_contiguous()
            and grids.is_contiguous()):
        ps, gs = pts.shape, grids.shape
        if (len(ps) == 3 and len(gs) == 3 and ps[2] == 2 and ps[0] == gs[0]
                and gs[1] >= 2 and gs[2] >= 2
                and pts.get_device() == grids.get_device()):
            return ps[0], ps[1], gs[1], gs[2]
    return None


def _f64(pts64: torch.Tensor, grids64: torch.Tensor, B: int, Q: int, H: int,
         W: int) -> torch.Tensor:
    """Launch K6 on checked tensors: the bound C function called with the
    pointers, the sizes and the raw stream handle, on the tensors' device.
    This is ``_build.launch`` written out: the helper's extra call cost
    0.7-1 us of a ~12 us call on the card's host (tools/host_overhead.py,
    ``f64_launch_helper_no_launch`` against ``f64_ctypes_call_no_launch``)."""
    out = torch.empty(B, Q, dtype=torch.float64, device=pts64.device)
    dev = pts64.get_device()
    args = (pts64.data_ptr(), grids64.data_ptr(), out.data_ptr(), B, Q, H, W,
            torch._C._cuda_getCurrentRawStream(dev))
    fn = _build.entry("atorch_bilinear_f64")
    if dev == torch._C._cuda_getDevice():
        code = fn(*args)
    else:
        with torch.cuda.device(dev):
            code = fn(*args)
    if code:
        _build.check(_build.load_library(), code, "bilinear_f64 kernel launch")
    LAUNCHES["bilinear_f64"] += 1
    return out


def f64_cuda(pts64: torch.Tensor, grids64: torch.Tensor) -> torch.Tensor:
    """K6 on the card: several queries a thread, in double throughout."""
    dims = _f64_dims(pts64, grids64)
    if dims is None:
        _check_kernel_args("f64_cuda", pts64, grids64, torch.float64,
                           (torch.float64,))
        dims = (*pts64.shape[:2], *grids64.shape[1:])
    return _f64(pts64, grids64, *dims)


# ------------------------------------------------------- entry points

def bilinear_batched(pts: torch.Tensor, grids: torch.Tensor,
                     precision: str = "bf16x2",
                     method: str = "auto") -> torch.Tensor:
    """Batched 2-D bilinear lookup: ``pts (B, Q, 2)`` (row, col) in index
    space, clamped to the grid, in ``grids (B, H, W)``; returns ``(B, Q)``
    in ``grids.dtype``, computed in f32.

    ``precision``: ``"bf16x2"`` (exact f32) or ``"bf16"`` (the grid read at
    bf16 precision).  ``method``: ``"full"`` (gather kernel), ``"binned"``
    (bin-window kernel) or ``"auto"`` (binned above 4 tiles of 128x128).
    """
    _, _, H, W = _check_inputs("bilinear_batched", pts, grids)
    if precision not in ("bf16x2", "bf16"):
        raise ValueError(f"precision must be 'bf16x2' or 'bf16'; got "
                         f"{precision!r}")
    if method not in ("auto", "full", "binned"):
        raise ValueError(f"method must be 'auto', 'full' or 'binned'; got "
                         f"{method!r}")
    if method == "auto":
        method = _auto_bilinear_method(H, W)
    p = pts.to(torch.float32)
    g = grids.to(torch.float32)
    if precision == "bf16":
        g = bf16_grid(g)
    if p.device.type == "cuda":
        out = _binned(g, _bin(p, H, W)) if method == "binned" else \
            _gather(p, g)
    elif method == "binned":
        out = binned_plain(g, bin_queries(p, H, W))
    else:
        out = gather_plain(p, g)
    return out.to(grids.dtype)


def bilinear_batched_f64(pts: torch.Tensor,
                         grids: torch.Tensor) -> torch.Tensor:
    """Batched 2-D bilinear at full f64 accuracy: the arguments of
    :func:`bilinear_batched`, cast to float64; ``H*W <= MAX_TABLE``, the
    JAX package's limit, so that both packages take the same inputs."""
    dims = _f64_dims(pts, grids)
    if dims is not None and dims[2] * dims[3] <= MAX_TABLE:
        return _f64(pts, grids, *dims)
    dims = _check_inputs("bilinear_batched_f64", pts, grids)
    if dims[2] * dims[3] > MAX_TABLE:
        raise ValueError(f"grid too large: {dims[2]}x{dims[3]} has more "
                         f"than MAX_TABLE = {MAX_TABLE} nodes")
    p = pts if pts.dtype is torch.float64 else pts.to(torch.float64)
    g = grids if grids.dtype is torch.float64 else grids.to(torch.float64)
    return _f64(p, g, *dims) if p.is_cuda else f64_plain(p, g)
