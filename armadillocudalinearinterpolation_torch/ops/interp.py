"""Batched linear interpolation in plain PyTorch (the reference semantics).

The same five functions as the JAX package's ``ops/interp.py``: clamped 1-D
lerp on non-uniform (``numpy.interp`` / ``arma::interp1`` semantics) and
uniform nodes, and 2-D bilinear lookup in index coordinates, one grid or a
batch of grids.  The CUDA kernels in :mod:`.interp_cuda` are held against
these.  The batch of grids is an explicit dimension (a flat ``gather`` on
``grids.view(B, H*W)``), and the blend keeps the reference's operation
order, ``lerp(g00, g01, tc)`` and ``lerp(g10, g11, tc)`` then
``lerp(top, bot, tr)``, so that a kernel built without fused multiply-adds
gives the same bits.
"""

from __future__ import annotations

import torch


def lerp(x0, x1, t):
    """Affine blend ``x0 + t*(x1-x0)``, the primitive behind every op here."""
    return x0 + t * (x1 - x0)


def interp1d(xq: torch.Tensor, xp: torch.Tensor,
             fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation at ``xq`` on strictly increasing nodes
    ``xp`` (``(n,)``) with values ``fp``; queries are clamped to the table
    range (constant extrapolation)."""
    n = xp.shape[0]
    hi = torch.clamp(torch.searchsorted(xp, xq.contiguous(), right=True),
                     1, n - 1)
    lo = hi - 1
    x0, x1 = xp[lo], xp[hi]
    t = (torch.clamp(xq, xp[0], xp[-1]) - x0) / (x1 - x0)
    return lerp(fp[lo], fp[hi], t)


def lerp_uniform(xq: torch.Tensor, fp: torch.Tensor, x0: float,
                 dx: float) -> torch.Tensor:
    """1-D lerp on the uniform grid ``x_i = x0 + i*dx``, clamped.

    ``floor(u)`` is clamped in floating point before the integer conversion,
    which would wrap a query at or past 2^63 cells (``1e30``, ``inf``) to
    cell 0; the JAX conversion saturates instead."""
    n = fp.shape[0]
    u = (xq - x0) / dx
    i0 = torch.clamp(torch.clamp(torch.floor(u), -1.0, n - 1.0).long(), 0,
                     n - 2)
    t = torch.clamp(u - i0.to(u.dtype), 0.0, 1.0)
    return lerp(fp[i0], fp[i0 + 1], t)


def bilinear_corners(pts: torch.Tensor, h: int, w: int):
    """Clamped index-space coordinates of ``pts (..., 2)`` on an ``h x w``
    grid: the upper-left corner ``(r0, c0)`` (int64) and the fractions
    ``(tr, tc)``."""
    r = torch.clamp(pts[..., 0], 0.0, h - 1.0)
    c = torch.clamp(pts[..., 1], 0.0, w - 1.0)
    r0 = torch.clamp(torch.floor(r).long(), 0, h - 2)
    c0 = torch.clamp(torch.floor(c).long(), 0, w - 2)
    return r0, c0, r - r0.to(r.dtype), c - c0.to(c.dtype)


def blend(flat: torch.Tensor, i00: torch.Tensor, w: int, tr: torch.Tensor,
          tc: torch.Tensor) -> torch.Tensor:
    """The 4-corner blend at flat upper-left indices ``i00 (B, Q)`` into the
    rows of ``flat (B, H*W)``, in the reference's operation order."""
    g00 = torch.gather(flat, 1, i00)
    g01 = torch.gather(flat, 1, i00 + 1)
    g10 = torch.gather(flat, 1, i00 + w)
    g11 = torch.gather(flat, 1, i00 + w + 1)
    top = lerp(g00, g01, tc)
    bot = lerp(g10, g11, tc)
    return lerp(top, bot, tr)


def bilinear_batched(pts: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of ``pts (B, ..., 2)`` (row, col) in index space,
    clamped to ``[0, H-1] x [0, W-1]``, in the matching grid of
    ``grids (B, H, W)``; returns ``(B, ...)``."""
    B, h, w = grids.shape
    p = pts.reshape(B, -1, 2)
    r0, c0, tr, tc = bilinear_corners(p, h, w)
    out = blend(grids.reshape(B, h * w), r0 * w + c0, w, tr, tc)
    return out.reshape(pts.shape[:-1])


def bilinear(pts: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of ``pts (..., 2)`` in one ``(H, W)`` grid."""
    return bilinear_batched(pts[None], grid[None])[0]
