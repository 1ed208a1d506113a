"""1-D linear interpolation on hand-written CUDA kernels
(``csrc/interp1d.cu``): the counterpart of the 1-D half of the JAX
package's ``ops/interp_pallas.py``.

Public entry points, with the JAX functions' contracts (queries of any
shape, f32 compute, result in ``xq.dtype``, tables of at most
``MAX_TABLE`` nodes):

- :func:`lerp1d` ``(xq, fp, x0, dx)``: clamped lerp on the uniform grid
  ``x0 + i*dx`` (K3).
- :func:`lerp1d_binned` ``(xq, fp, x0, dx, n_batches=512)``: the same
  function on value-sorted batches of queries (K4).
- :func:`make_interp1d` ``(xp, fp, oversample=4)`` and :func:`interp1d`:
  strictly increasing non-uniform nodes, ``numpy.interp`` semantics (K5);
  the interpolant's ``method="sorted"`` runs K5 on value-sorted batches.

The entry points send no query to a sorted route of their own accord,
where the JAX package's thresholds do (``interp_pallas.py:300,517``): on
an H100 the batch sort alone takes longer than K3 or K5 on the unsorted
queries at every table size (1k to 64k nodes), query count (131072 to 10M)
and distribution (uniform, already sorted, clustered) that
``tools/interp1d_route_study.py`` measured.

Each kernel has a plain PyTorch version beside it (:func:`lerp1d_plain`,
:func:`lerp1d_sorted_plain`, :func:`interp1d_plain`) that follows the
kernel's arithmetic step by step.  CUDA tensors launch the kernel, CPU
tensors take the plain version, anything else raises; nothing falls back.
``LAUNCHES`` counts the launches of each kernel by name.  The TPU kernels'
chunked in-vreg sweeps, pre-shifted table copies, f32-coded bucket table
and restore sorts are not carried over: the card gathers directly, and the
sorted routes write each result straight to its query id.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .interp import lerp

MAX_TABLE = 65536          # table nodes the JAX package's kernels accept
_F32_MAX = float(np.finfo(np.float32).max)

LAUNCHES = {"lerp1d": 0, "lerp1d_sorted": 0, "interp1d": 0}


def _pow2_batches(Q: int, target_qb: int = 4096) -> int:
    """Batch count of the sorted non-uniform route: the largest power of
    two with row length >= ``target_qb``, between 8 and 512.

    The JAX package's rule (``interp_pallas.py:83-92``), set by its sorts on
    a v5e; kept unchanged on the card."""
    return max(8, min(512, 1 << max(0, (Q // target_qb).bit_length() - 1)))


def _check_nodes(n: int) -> None:
    if n > MAX_TABLE:
        raise ValueError(f"table too large: {n} > {MAX_TABLE}")
    if n < 2:
        raise ValueError("need at least 2 nodes")


def _check_queries(fn: str, xq: torch.Tensor, table: torch.Tensor) -> None:
    """Types and devices the entry points take."""
    if not (xq.is_floating_point() and table.is_floating_point()):
        raise TypeError(f"{fn}: queries and table must be floating point; "
                        f"got {xq.dtype} and {table.dtype}")
    if xq.device != table.device:
        raise ValueError(f"{fn}: queries and table must be on one device; "
                         f"got {xq.device} and {table.device}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: CUDA tensors run the kernel and CPU tensors "
                         f"its plain version; got {xq.device}")


def _check_uniform(fn: str, xq: torch.Tensor, fp: torch.Tensor) -> None:
    if fp.ndim != 1:
        raise ValueError(f"{fn}: fp must be 1-D; got {tuple(fp.shape)}")
    _check_nodes(fp.shape[0])
    _check_queries(fn, xq, fp)


def uniform_lims(x0: float, dx: float) -> tuple[float, float]:
    """``(x0, 1/dx)`` rounded to f32, as the JAX package's
    ``jnp.array([x0, 1.0 / dx], jnp.float32)`` makes them."""
    x0_32, inv_dx = np.array([float(x0), 1.0 / float(dx)], np.float32)
    return float(x0_32), float(inv_dx)


def _flat_f32(xq: torch.Tensor) -> torch.Tensor:
    return xq.reshape(-1).to(torch.float32).contiguous()


def _on_card(x: torch.Tensor) -> bool:
    """The entry points' one device decision: CUDA tensors launch the
    kernels, CPU tensors (all the checks leave) take the plain versions.
    A CPU rehearsal of ``chip_smoke.py`` replaces it."""
    return x.device.type == "cuda"


# ------------------------------------------------------- plain versions

def _cell(u: torch.Tensor, n: int) -> torch.Tensor:
    """``clamp(trunc(u), 0, n-2)`` as int64.  ``u`` is clamped to
    ``[-1, n-1]`` first, which changes no cell: the kernel's conversion
    saturates, and an unclamped ``1e30`` or ``inf`` would wrap here."""
    return torch.clamp(torch.clamp(u, -1.0, n - 1.0).long(), 0, n - 2)


def lerp1d_plain(q32: torch.Tensor, fp32: torch.Tensor, x0: float,
                 inv_dx: float) -> torch.Tensor:
    """Plain version of K3 (``interp_pallas.py:255-282``): ``u = (q - x0) *
    inv_dx``, cell ``i0 = clamp(trunc(u), 0, n-2)``, ``t = clamp(u - i0, 0,
    1)``, then ``f[i0] + t*(f[i0+1] - f[i0])``, in f32."""
    u = (q32 - x0) * inv_dx
    i0 = _cell(u, fp32.shape[0])
    t = torch.clamp(u - i0.to(u.dtype), 0.0, 1.0)
    return lerp(fp32[i0], fp32[i0 + 1], t)


def sort_batches(q32: torch.Tensor, n_batches: int):
    """Split ``q32 (Q,)`` into ``n_batches`` rows of ``Qb = ceil(Q /
    n_batches)`` consecutive query ids and value-sort each row.

    Pads (+f32 max, ids ``>= Q``) fill the end of the last rows and are
    never written out.  Returns ``(qs, order)``, both ``(n_batches * Qb,)``:
    the sorted values and the query id at each sorted position.  The sort
    is not stable; tied values interpolate alike."""
    Q = q32.shape[0]
    Qb = -(-Q // n_batches)
    total = n_batches * Qb
    qp = q32 if total == Q else torch.cat(
        [q32, q32.new_full((total - Q,), _F32_MAX)])
    qs, idx = torch.sort(qp.view(n_batches, Qb), dim=1)
    order = idx + torch.arange(0, total, Qb, device=q32.device)[:, None]
    return qs.reshape(-1), order.reshape(-1)


def _scatter(vals: torch.Tensor, order: torch.Tensor, Q: int) -> torch.Tensor:
    """``out[order[k]] = vals[k]``, pads (ids ``>= Q``) dropped (``order``
    is a permutation of ``range(len(vals))``)."""
    return torch.empty_like(vals).scatter_(0, order, vals)[:Q]


def lerp1d_sorted_plain(qs: torch.Tensor, order: torch.Tensor,
                        fp32: torch.Tensor, x0: float, inv_dx: float,
                        Q: int) -> torch.Tensor:
    """Plain version of K4: K3's formula on the sorted values, each result
    written to its query id."""
    return _scatter(lerp1d_plain(qs, fp32, x0, inv_dx), order, Q)


@dataclasses.dataclass(frozen=True, eq=False)
class Interp1d:
    """The interpolant :func:`make_interp1d` builds; call it on queries.

    The tables live on ``fp``'s device.  ``nodes`` row ``i`` is ``xp[i],
    xp[i+1], fp[i], fp[i+1]`` in f32 (``+inf`` and ``0`` past the last
    node), one 16-byte load per node: the counterpart of the TPU's
    interleaved ``packed`` table (``interp_pallas.py:470-475``).
    """
    bucket: torch.Tensor     # (m,) int32: the node at or left of each edge
    nodes: torch.Tensor      # (n, 4) f32
    S: int                   # advance steps from a (stepped-back) seed
    lims: tuple              # (e0, inv_du, x_lo, x_hi), f32 values

    @property
    def n(self) -> int:
        return self.nodes.shape[0]

    @property
    def m(self) -> int:
        return self.bucket.shape[0]

    def __call__(self, xq: torch.Tensor, *,
                 method: str = "direct") -> torch.Tensor:
        """Interpolate ``xq``.  ``method``: ``"direct"`` (K5 on the
        queries in id order) or ``"sorted"`` (value-sorted batches, K5
        with an order array).  Both routes compute the same values."""
        _check_queries("interp1d", xq, self.nodes)
        if method not in ("direct", "sorted"):
            raise ValueError(f"method must be 'direct' or 'sorted'; got "
                             f"{method!r}")
        q = _flat_f32(xq)
        Q = q.shape[0]
        if Q == 0:
            return torch.empty(xq.shape, dtype=xq.dtype, device=xq.device)
        run = interp1d_cuda if _on_card(q) else interp1d_plain
        if method == "sorted":
            qs, order = sort_batches(q, _pow2_batches(Q))
            out = run(self, qs, order, Q)
        else:
            out = run(self, q)
        return out.reshape(xq.shape).to(xq.dtype)


def interp1d_plain(table: Interp1d, q32: torch.Tensor,
                   order: torch.Tensor | None = None,
                   Q: int | None = None) -> torch.Tensor:
    """Plain version of K5 (``interp_pallas.py:356-414``): clamp to the
    nodes, seed from the bucket map, step back a bucket if the seed node
    lies right of the query, ``S`` bounded advance steps, then the blend
    with ``t = clamp((qc - x0) / (x1 - x0), 0, 1)``.  With ``order``,
    ``q32`` holds sorted values and each result goes to its query id."""
    _, _, x_lo, x_hi = table.lims
    qc = torch.clamp(q32, x_lo, x_hi)
    lo = interp1d_bracket(table, qc)
    x0, x1, f0, f1 = table.nodes[lo].unbind(1)
    t = torch.clamp((qc - x0) / (x1 - x0), 0.0, 1.0)
    vals = lerp(f0, f1, t)
    return vals if order is None else _scatter(vals, order, Q)


def interp1d_bracket(table: Interp1d, qc: torch.Tensor) -> torch.Tensor:
    """K5's bracket of clamped queries ``qc``, as int64: ``lo`` with
    ``xp[lo] <= qc < xp[lo+1]``, or ``n-2`` at the last node."""
    e0, inv_du, _, _ = table.lims
    xp, xp1 = table.nodes[:, 0], table.nodes[:, 1]
    bucket = table.bucket.long()
    k = torch.clamp(((qc - e0) * inv_du).long(), 0, table.m - 1)
    # f32 rounding of (qc - e0) * inv_du can overshoot the bucket by one
    # near an edge: step back if the seed node lies right of the query
    k = k - ((xp[bucket[k]] > qc) & (k > 0)).long()
    lo = bucket[k]
    for _ in range(table.S):
        lo = lo + ((xp1[lo] <= qc) & (lo < table.n - 2)).long()
    return lo


# ------------------------------------------------------ kernel wrappers

def _launch(key: str, entry: str, dev: torch.device, *args) -> None:
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(*args, stream)
    _build.check(lib, code, f"{key} kernel launch")
    LAUNCHES[key] += 1


def _check_kernel_args(fn: str, table: torch.Tensor,
                       *tensors: torch.Tensor) -> None:
    """CUDA tensors on one device, contiguous, f32 (int64 ids)."""
    for x in (table, *tensors):
        if x.device.type != "cuda":
            raise ValueError(f"{fn} needs CUDA tensors; got {x.device} (the "
                             "plain version serves CPU tensors)")
        if x.device != table.device:
            raise ValueError(f"{fn}: tensors must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: tensors must be contiguous")
        if x.dtype not in (torch.float32, torch.int64, torch.int32):
            raise TypeError(f"{fn}: got a {x.dtype} tensor")


def _check_order(fn: str, qs: torch.Tensor, order: torch.Tensor,
                 Q: int) -> None:
    if (qs.dtype != torch.float32 or order.dtype != torch.int64
            or qs.ndim != 1 or order.shape != qs.shape
            or not 0 <= Q <= qs.shape[0]):
        raise ValueError(f"{fn}: qs and order must come from sort_batches")


def lerp1d_cuda(q32: torch.Tensor, fp32: torch.Tensor, x0: float,
                inv_dx: float) -> torch.Tensor:
    """K3 on the card: one thread per query, grid-stride."""
    _check_kernel_args("lerp1d_cuda", fp32, q32)
    if q32.dtype != torch.float32 or fp32.dtype != torch.float32:
        raise TypeError("lerp1d_cuda: queries and table must be float32")
    out = torch.empty_like(q32)
    _launch("lerp1d", "atorch_lerp1d", q32.device, q32.data_ptr(),
            fp32.data_ptr(), out.data_ptr(), q32.numel(), fp32.shape[0], x0,
            inv_dx)
    return out


def lerp1d_sorted_cuda(qs: torch.Tensor, order: torch.Tensor,
                       fp32: torch.Tensor, x0: float, inv_dx: float,
                       Q: int, n_batches: int) -> torch.Tensor:
    """K4 on the card, on ``n_batches`` rows of sorted values ``qs`` and
    their ids ``order``, a permutation of ``range(len(qs))`` with the pads
    (ids ``>= Q``) anywhere: one CTA per batch of up to 12288 queries, each
    result put in shared memory at its id's place and the batch written out
    in id order where its ids are its own range (as :func:`sort_batches`
    makes them), else each result written straight to its id; larger
    batches write each result straight to its id."""
    _check_kernel_args("lerp1d_sorted_cuda", fp32, qs, order)
    _check_order("lerp1d_sorted_cuda", qs, order, Q)
    if fp32.dtype != torch.float32 or qs.shape[0] % n_batches:
        raise ValueError("lerp1d_sorted_cuda: a float32 table and "
                         "n_batches rows of sorted queries")
    out = torch.empty(Q, dtype=torch.float32, device=qs.device)
    _launch("lerp1d_sorted", "atorch_lerp1d_sorted", qs.device,
            qs.data_ptr(), order.data_ptr(), fp32.data_ptr(), out.data_ptr(),
            Q, n_batches, qs.shape[0] // n_batches, fp32.shape[0], x0, inv_dx)
    return out


def interp1d_cuda(table: Interp1d, q32: torch.Tensor,
                  order: torch.Tensor | None = None,
                  Q: int | None = None) -> torch.Tensor:
    """K5 on the card: one thread per query, grid-stride.  With ``order``,
    ``q32`` holds sorted values and each result goes to its query id."""
    _check_kernel_args("interp1d_cuda", table.nodes, q32, table.bucket)
    if q32.dtype != torch.float32 or q32.ndim != 1:
        raise TypeError("interp1d_cuda: queries must be flat float32")
    if order is None:
        Q = q32.shape[0]
    else:
        _check_kernel_args("interp1d_cuda", table.nodes, order)
        _check_order("interp1d_cuda", q32, order, Q)
    out = torch.empty(Q, dtype=torch.float32, device=q32.device)
    _launch("interp1d", "atorch_interp1d", q32.device, q32.data_ptr(),
            None if order is None else order.data_ptr(),
            table.bucket.data_ptr(), table.nodes.data_ptr(), out.data_ptr(),
            Q, q32.shape[0], table.n, table.m, table.S, *table.lims)
    return out


# ------------------------------------------------------- entry points

def lerp1d(xq: torch.Tensor, fp: torch.Tensor, x0: float,
           dx: float) -> torch.Tensor:
    """Uniform-grid 1-D lerp, clamped: ``numpy.interp`` on the nodes
    ``x0 + i*dx``.  Queries of any shape, computed in f32, returned in
    ``xq.dtype``; ``fp`` has 2 to ``MAX_TABLE`` nodes."""
    _check_uniform("lerp1d", xq, fp)
    q = _flat_f32(xq)
    if q.shape[0] == 0:
        return torch.empty(xq.shape, dtype=xq.dtype, device=xq.device)
    fp32 = fp.to(torch.float32).contiguous()
    run = lerp1d_cuda if _on_card(q) else lerp1d_plain
    return run(q, fp32, *uniform_lims(x0, dx)).reshape(xq.shape).to(
        xq.dtype)


def lerp1d_binned(xq: torch.Tensor, fp: torch.Tensor, x0: float, dx: float,
                  *, n_batches: int = 512) -> torch.Tensor:
    """:func:`lerp1d`'s function on value-sorted batches: the queries are
    split into ``n_batches`` contiguous id ranges, each is value-sorted
    (:func:`sort_batches`), and K4 computes them in sorted order and writes
    each result to its query id."""
    _check_uniform("lerp1d_binned", xq, fp)
    if not (isinstance(n_batches, int) and n_batches >= 1):
        raise ValueError(f"n_batches must be a positive int; got "
                         f"{n_batches!r}")
    q = _flat_f32(xq)
    Q = q.shape[0]
    if Q == 0:
        return torch.empty(xq.shape, dtype=xq.dtype, device=xq.device)
    fp32 = fp.to(torch.float32).contiguous()
    lims = uniform_lims(x0, dx)
    qs, order = sort_batches(q, n_batches)
    if _on_card(q):
        out = lerp1d_sorted_cuda(qs, order, fp32, *lims, Q, n_batches)
    else:
        out = lerp1d_sorted_plain(qs, order, fp32, *lims, Q)
    return out.reshape(xq.shape).to(xq.dtype)


def make_interp1d(xp: torch.Tensor, fp: torch.Tensor, *,
                  oversample: int = 4) -> Interp1d:
    """Build the interpolant of strictly increasing nodes ``xp (n,)`` with
    values ``fp (n,)``, clamped at the table ends (``numpy.interp``
    semantics); ``2 <= n <= MAX_TABLE``.

    The host prep is the JAX package's (``interp_pallas.py:443-478``), in
    float64: ``m`` uniform buckets (``oversample`` per node, a power of two
    of at least 128), the node at or left of each bucket edge, and the
    bound ``S`` on the advance steps, sized for the two-bucket span since a
    seed may step back one bucket.  The tables go to ``fp``'s device.
    """
    if xp.ndim != 1 or fp.shape != xp.shape:
        raise ValueError(f"make_interp1d: xp and fp must be (n,); got "
                         f"{tuple(xp.shape)} and {tuple(fp.shape)}")
    n = xp.shape[0]
    _check_nodes(n)
    xp_h = xp.detach().cpu().to(torch.float64).numpy()
    if not (np.diff(xp_h) > 0).all():
        raise ValueError("xp must be strictly increasing")
    if not fp.is_floating_point():
        raise TypeError(f"make_interp1d: fp must be floating point; got "
                        f"{fp.dtype}")
    if fp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"make_interp1d: CUDA tensors run the kernel and "
                         f"CPU tensors its plain version; got {fp.device}")

    m = min(max(128, 1 << (oversample * n - 1).bit_length()), 4 * MAX_TABLE)
    edges = xp_h[0] + (xp_h[-1] - xp_h[0]) * np.arange(m) / m
    bucket = np.clip(np.searchsorted(xp_h, edges, side="right") - 1, 0,
                     n - 2)
    ext = np.append(bucket, [n - 2, n - 2])
    S = int(np.max(ext[2:] - bucket)) + 1
    lims = np.array([edges[0], m / (xp_h[-1] - xp_h[0]), xp_h[0], xp_h[-1]],
                    np.float32)

    dev = fp.device
    x32 = xp.detach().to(dev, torch.float32)
    f32 = fp.detach().to(torch.float32)
    nodes = torch.stack([
        x32, torch.cat([x32[1:], x32.new_full((1,), float("inf"))]),
        f32, torch.cat([f32[1:], f32.new_zeros(1)])], dim=1).contiguous()
    return Interp1d(bucket=torch.from_numpy(bucket.astype(np.int32)).to(dev),
                    nodes=nodes, S=S, lims=tuple(float(v) for v in lims))


def interp1d(xq: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
             **kw) -> torch.Tensor:
    """One-shot non-uniform interpolation: :func:`make_interp1d`, then the
    call; for repeated queries against one table build it once."""
    return make_interp1d(xp, fp, **kw)(xq)
