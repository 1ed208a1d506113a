"""Batched 2-D bilinear interpolation on hand-written CUDA kernels
(``csrc/interp2d.cu``): the counterpart of the 2-D half of the JAX
package's ``ops/interp_pallas.py``.

Public entry points, with the JAX functions' contracts:

- :func:`bilinear_batched` ``(pts, grids, precision, method)``: f32
  compute, result in ``grids.dtype``.  ``method="full"`` runs the gather
  kernel (K7), ``"binned"`` the bin-window kernel (K8), ``"auto"`` picks
  by grid size with the JAX package's rule (:func:`_auto_bilinear_method`).
  ``precision="bf16x2"`` is exact f32; ``"bf16"`` reads the grid at bf16
  precision (the top 16 bits of each f32, masked as the JAX package masks
  its high part) and blends in f32.
- :func:`bilinear_batched_f64` ``(pts, grids)``: native fp64 (K6), with the
  JAX package's ``MAX_TABLE`` limit on ``H*W``.

Each kernel has a plain PyTorch version beside it (:func:`gather_plain`,
:func:`binned_plain`, :func:`f64_plain`).  CUDA tensors launch the kernel,
CPU tensors take the plain version, anything else raises; nothing falls
back.  ``LAUNCHES`` counts the launches of each kernel by name.  The tent
weights, bf16 hi/lo splits, hi/lo f32 tables, query sub-tiling and restore
sort of the TPU kernels are not carried over: the card gathers directly.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .interp import bilinear_batched as _bilinear_plain
from .interp import bilinear_corners, blend

MAX_TABLE = 65536       # f64 grid nodes the JAX package's kernel accepts
_TILE = 128             # grid tile of the auto rule
_BIN_MAX_EDGE = 120     # bin extent of the binned path (JAX :667)
_HI_MASK = -65536       # 0xFFFF0000 as an int32: sign, exponent, 7 mantissa bits

LAUNCHES = {"bilinear_gather": 0, "bilinear_binned": 0, "bilinear_f64": 0}


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


# ------------------------------------------------------------- binning

@dataclasses.dataclass(frozen=True)
class Bins:
    """Queries grouped by grid bin, per grid.

    Bin ``k`` of grid ``b`` holds the queries
    ``order[b, offsets[b, k]:offsets[b, k + 1]]``; it covers corner rows
    ``[(k // nbc) * be_r, +be_r)`` and columns ``[(k % nbc) * be_c, +be_c)``,
    so its queries read the ``(be_r + 1) x (be_c + 1)`` nodes from there.
    """
    order: torch.Tensor      # (B, Q) int64 query ids, bin by bin
    offsets: torch.Tensor    # (B, nbins + 1) int64
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
    """Bin each query by its upper-left corner: bin ids, per-bin counts
    (``bincount``), offsets (``cumsum``) and the query order (stable
    ``argsort`` of the bin ids)."""
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
    return Bins(order=order, offsets=offsets, nbc=nbc, be_r=be_r, be_c=be_c)


# ---------------------------------------------------- plain versions

def gather_plain(pts32: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather kernel: f32 bilinear of ``pts32
    (B, Q, 2)`` in ``grid (B, H, W)`` (f32, or the bf16 copy)."""
    return _bilinear_plain(pts32, grid.float())


def binned_plain(pts32: torch.Tensor, grid: torch.Tensor,
                 bins: Bins) -> torch.Tensor:
    """Plain version of the bin-window kernel: each query, in bin order,
    reads its corners relative to its bin's window, and the result goes
    back to its query id."""
    B, Q, _ = pts32.shape
    _, h, w = grid.shape
    order = bins.order
    p = torch.gather(pts32, 1, order[..., None].expand(B, Q, 2))
    # bin of sorted position k: the number of bins that end at or before k
    k = torch.arange(Q, device=p.device).expand(B, Q).contiguous()
    bin_k = torch.searchsorted(bins.offsets[:, 1:].contiguous(), k,
                               right=True)
    rb = (bin_k // bins.nbc) * bins.be_r
    cb = (bin_k % bins.nbc) * bins.be_c
    r0, c0, tr, tc = bilinear_corners(p, h, w)
    lr = torch.clamp(r0 - rb, 0, bins.be_r - 1)
    lc = torch.clamp(c0 - cb, 0, bins.be_c - 1)
    vals = blend(grid.float().reshape(B, h * w), (rb + lr) * w + cb + lc, w,
                 tr, tc)
    return torch.empty_like(vals).scatter_(1, order, vals)


def f64_plain(pts64: torch.Tensor, grids64: torch.Tensor) -> torch.Tensor:
    """Plain version of the f64 kernel: bilinear in float64."""
    return _bilinear_plain(pts64, grids64)


# ------------------------------------------------------ kernel wrappers

def _check_kernel_args(fn: str, pts: torch.Tensor, grid: torch.Tensor,
                       pts_dtype, grid_dtypes) -> None:
    B, _, _, _ = _check_inputs(fn, pts, grid)
    if pts.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors; got {pts.device} (the "
                         "plain version serves CPU tensors)")
    if pts.dtype != pts_dtype or grid.dtype not in grid_dtypes:
        raise TypeError(f"{fn}: pts must be {pts_dtype} and the grid one of "
                        f"{grid_dtypes}; got {pts.dtype} and {grid.dtype}")


def _launch(key: str, entry: str, dev: torch.device, *args) -> None:
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(*args, stream)
    _build.check(lib, code, f"{key} kernel launch")
    LAUNCHES[key] += 1


def gather_cuda(pts32: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """K7 on the card: one thread per query, corners from device memory."""
    _check_kernel_args("gather_cuda", pts32, grid, torch.float32,
                       (torch.float32, torch.bfloat16))
    B, Q, _ = pts32.shape
    _, H, W = grid.shape
    out = torch.empty(B, Q, dtype=torch.float32, device=pts32.device)
    _launch("bilinear_gather", "atorch_bilinear_gather", pts32.device,
            pts32.data_ptr(), grid.data_ptr(), out.data_ptr(), B, Q, H, W,
            int(grid.dtype == torch.bfloat16))
    return out


def binned_cuda(pts32: torch.Tensor, grid: torch.Tensor,
                bins: Bins) -> torch.Tensor:
    """K8 on the card: one CTA per (grid, bin), the bin's window in shared
    memory, a loop over however many queries the bin holds."""
    _check_kernel_args("binned_cuda", pts32, grid, torch.float32,
                       (torch.float32, torch.bfloat16))
    B, Q, _ = pts32.shape
    _, H, W = grid.shape
    order, offsets = bins.order, bins.offsets
    if (order.shape != (B, Q) or offsets.shape[0] != B
            or order.dtype != torch.int64 or offsets.dtype != torch.int64
            or order.device != pts32.device or offsets.device != pts32.device
            or not (order.is_contiguous() and offsets.is_contiguous())):
        raise ValueError("binned_cuda: bins must come from bin_queries on "
                         "the same queries")
    out = torch.empty(B, Q, dtype=torch.float32, device=pts32.device)
    _launch("bilinear_binned", "atorch_bilinear_binned", pts32.device,
            pts32.data_ptr(), grid.data_ptr(), order.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), B, Q, H, W, bins.nbins,
            bins.nbc, bins.be_r, bins.be_c,
            int(grid.dtype == torch.bfloat16))
    return out


def f64_cuda(pts64: torch.Tensor, grids64: torch.Tensor) -> torch.Tensor:
    """K6 on the card: one thread per query, in double throughout."""
    _check_kernel_args("f64_cuda", pts64, grids64, torch.float64,
                       (torch.float64,))
    B, Q, _ = pts64.shape
    _, H, W = grids64.shape
    out = torch.empty(B, Q, dtype=torch.float64, device=pts64.device)
    _launch("bilinear_f64", "atorch_bilinear_f64", pts64.device,
            pts64.data_ptr(), grids64.data_ptr(), out.data_ptr(), B, Q, H, W)
    return out


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
    on_card = p.device.type == "cuda"
    if method == "binned":
        bins = bin_queries(p, H, W)
        out = binned_cuda(p, g, bins) if on_card else binned_plain(p, g, bins)
    else:
        out = gather_cuda(p, g) if on_card else gather_plain(p, g)
    return out.to(grids.dtype)


def bilinear_batched_f64(pts: torch.Tensor,
                         grids: torch.Tensor) -> torch.Tensor:
    """Batched 2-D bilinear at full f64 accuracy: the arguments of
    :func:`bilinear_batched`, cast to float64; ``H*W <= MAX_TABLE``, the
    JAX package's limit, so that both packages take the same inputs."""
    _, _, H, W = _check_inputs("bilinear_batched_f64", pts, grids)
    if H * W > MAX_TABLE:
        raise ValueError(f"grid too large: {H}x{W} has more than "
                         f"MAX_TABLE = {MAX_TABLE} nodes")
    p = pts.to(torch.float64)
    g = grids.to(torch.float64)
    return f64_cuda(p, g) if p.device.type == "cuda" else f64_plain(p, g)
