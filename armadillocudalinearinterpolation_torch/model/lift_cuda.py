"""The lift as hand-written CUDA kernels (``csrc/lift.cu``): K9, the lift
of a stack of points, and K9T, the same lift with ``D`` forward tangents,
registered as the ops ``atorch::lift`` (:func:`lift_op`) and
``atorch::lift_tangent`` (:func:`lift_tangent_op`).

The ops are functional and pick their kernel by device: the ``ctypes``
launch for CUDA tensors (K9 float32 or float64, K9T float64; no fallback:
an input the kernel does not take, or a failed launch, raises), the plain
versions for CPU ones (:func:`.lift.lift_plain`, and
:func:`lift_tangent_plain`, the same loop on dual numbers).  Fake kernels
give the shapes.  ``atorch::lift_tangent``'s vmap rule folds a batch of
tangents into its ``D`` axis, so a whole ``torch.func.jacfwd`` is one
launch.  ``LAUNCHES`` and ``TANGENT_LAUNCHES`` count the launches of K9
and K9T.

:class:`.autodiff.DifferentiableLift` joins the two under PyTorch's
forward-mode AD; :func:`.lift.lift` calls it on CUDA tensors, and
:func:`lift_tangent` is what :func:`.emap.lift_tangents` calls.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..config import ModelConfig
from .evolve_cuda import config_key, config_of
from .lift import lift_plain

LAUNCHES = 0
TANGENT_LAUNCHES = 0
# the kernels' grid (csrc/lift.cu): grid.x the points times their tiles of
# 16, 32 or 64 sites, at most 2**31 - 1 (as is N, a C int) for the tiles
# of SITES_PER_CTA, the smallest; grid.y K9T's directions
SITES_PER_CTA = 16
MAX_GRID_X = 2**31 - 1
MAX_DIRECTIONS = 65535

_ENTRY = {torch.float32: "atorch_lift_f32", torch.float64: "atorch_lift_f64"}


def _constants(c: ModelConfig):
    """The model constants the kernels take, in their order."""
    return (c.a1, c.a2, c.b1, c.b2, c.drive, c.vth, c.half_width, c.dx)


def check_lift_inputs(c: ModelConfig, U: torch.Tensor,
                      beta: torch.Tensor) -> None:
    """Refuse what the lift ops do not take: ``U`` ``(P, n_spikes + 1)``
    float32 or float64, ``beta`` ``(P,)`` of its dtype and device, and no
    more tiles of ``n_neurons`` sites than one launch's grid holds."""
    M = c.n_spikes
    if U.ndim != 2 or U.shape[1] != M + 1 or U.dtype not in _ENTRY:
        raise ValueError(f"U must be (P, {M + 1}) float32 or float64; got "
                         f"{tuple(U.shape)} {U.dtype}")
    if (beta.shape != U.shape[:1] or beta.dtype != U.dtype
            or beta.device != U.device):
        raise ValueError(f"beta must be ({U.shape[0]},) {U.dtype} on "
                         f"{U.device}; got {tuple(beta.shape)} {beta.dtype} "
                         f"on {beta.device}")
    tiles = -(-c.n_neurons // SITES_PER_CTA)
    if c.n_neurons > MAX_GRID_X or U.shape[0] * tiles > MAX_GRID_X:
        raise ValueError(f"{U.shape[0]} points of {c.n_neurons} sites are "
                         f"{U.shape[0] * tiles} CTAs of {SITES_PER_CTA} "
                         f"sites, more than one launch takes ({MAX_GRID_X})")


def check_tangent_inputs(c: ModelConfig, U, beta, dU, dbeta) -> int:
    """:func:`check_lift_inputs`, and ``dU`` ``(D, P, n_spikes + 1)``,
    ``dbeta`` ``(D, P)`` of ``U``'s dtype and device, ``D`` at most
    ``MAX_DIRECTIONS``; returns ``D``."""
    check_lift_inputs(c, U, beta)
    D = dU.shape[0] if dU.ndim == 3 else 0
    if D > MAX_DIRECTIONS:
        raise ValueError(f"{D} directions: K9T takes at most "
                         f"{MAX_DIRECTIONS} in one launch")
    for name, x, shape in (("dU", dU, (D, *U.shape)),
                           ("dbeta", dbeta, (D, U.shape[0]))):
        if (D < 1 or x.shape != shape or x.dtype != U.dtype
                or x.device != U.device):
            raise ValueError(f"{name} must be (D, *{tuple(shape[1:])}) with "
                             f"D >= 1, {U.dtype} on {U.device}; got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return D


def _kernel_inputs(c: ModelConfig, U, beta):
    """``(P, N, M, beta_stride)`` for a launch: ``U`` must be contiguous;
    the kernels read ``beta`` at its own stride (0 for one rate expanded
    over the points, as the map passes it; a column of a larger tensor, as
    the bordered solvers pass theirs): no copy."""
    if not U.is_contiguous():
        raise ValueError("U must be contiguous")
    P = U.shape[0]
    return P, c.n_neurons, c.n_spikes, 0 if P == 1 else beta.stride(0)


@torch.library.custom_op("atorch::lift", mutates_args=(),
                         device_types="cuda")
def lift_op(cfg: str, U: torch.Tensor, beta: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 as an op: ``cfg`` a :func:`.evolve_cuda.config_key` string, ``U``
    the ``(P, n_spikes + 1)`` points, ``beta`` their ``(P,)`` mean rates;
    returns ``(v0, s0)``, each ``(P, n_neurons)``.  Its CUDA kernel
    launches K9 on the current stream (no synchronise) and raises on any
    input the kernel does not take; its CPU kernel is the plain version,
    :func:`.lift.lift_plain`."""
    global LAUNCHES
    c = config_of(cfg)
    check_lift_inputs(c, U, beta)
    P, N, M, stride = _kernel_inputs(c, U, beta)
    v0 = torch.empty(P, N, dtype=U.dtype, device=U.device)
    s0 = torch.empty_like(v0)
    _build.launch(_build.entry(_ENTRY[U.dtype]), "lift kernel launch",
                  U.device.index, U.data_ptr(), beta.data_ptr(),
                  v0.data_ptr(), s0.data_ptr(), P, N, M, stride,
                  *_constants(c))
    LAUNCHES += 1
    return v0, s0


@lift_op.register_kernel("cpu")
def _lift_plain(cfg, U, beta):
    c = config_of(cfg)
    check_lift_inputs(c, U, beta)
    return lift_plain(c, beta[:, None], U)


@lift_op.register_fake
def _lift_fake(cfg, U, beta):
    shape = (U.shape[0], config_of(cfg).n_neurons)
    return U.new_empty(shape), U.new_empty(shape)


class Dual:
    """A value and its tangents along ``D`` directions, the numbers the
    plain version of K9T runs :func:`.lift.lift_plain` on: ``value`` a
    tensor, ``tangent`` a tensor with one more leading axis (the
    directions) that broadcasts against it.  Arithmetic, ``exp`` and
    ``where`` follow PyTorch's forward-mode rules as K9T's dual numbers
    do (a product: t_b a + t_a b; a quotient: (t_a - t_b q) / b; ``1 /
    b``: -t r r; ``exp``: t e; a select keeps its branch's tangent); a
    comparison is the values'.  No AD level is entered, so the op's CPU
    kernel also runs under ``torch.autograd.forward_ad``, where
    ``torch.func.jvp`` cannot nest.  Indexing takes ``lift_plain``'s
    slices, which start with ``...``."""

    __slots__ = ("value", "tangent")

    def __init__(self, value: torch.Tensor, tangent: torch.Tensor):
        self.value, self.tangent = value, tangent

    shape = property(lambda self: self.value.shape)
    dtype = property(lambda self: self.value.dtype)
    device = property(lambda self: self.value.device)

    def __getitem__(self, idx):
        return Dual(self.value[idx], self.tangent[idx])

    def __neg__(self):
        return Dual(-self.value, -self.tangent)

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.value + o.value, self.tangent + o.tangent)
        return Dual(self.value + o, self.tangent)

    def __radd__(self, o):
        return Dual(o + self.value, self.tangent)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.value - o.value, self.tangent - o.tangent)
        return Dual(self.value - o, self.tangent)

    def __rsub__(self, o):
        return Dual(o - self.value, -self.tangent)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.value * o.value,
                        o.tangent * self.value + self.tangent * o.value)
        return Dual(self.value * o, self.tangent * o)

    def __rmul__(self, o):
        return Dual(o * self.value, self.tangent * o)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            q = self.value / o.value
            return Dual(q, (self.tangent - o.tangent * q) / o.value)
        return Dual(self.value / o, self.tangent / o)

    def __rtruediv__(self, o):
        q = o / self.value
        if isinstance(o, torch.Tensor):
            return Dual(q, -(self.tangent * q) / self.value)
        # a Python number: PyTorch takes the reciprocal, times o
        r = 1.0 / self.value
        return Dual(q, -self.tangent * (r * r) * o)

    def __gt__(self, o):
        return self.value > (o.value if isinstance(o, Dual) else o)

    def __lt__(self, o):
        return self.value < (o.value if isinstance(o, Dual) else o)

    def exp(self):
        e = self.value.exp()
        return Dual(e, self.tangent * e)

    def where(self, cond, o):
        if isinstance(o, Dual):
            return Dual(self.value.where(cond, o.value),
                        self.tangent.where(cond, o.tangent))
        return Dual(self.value.where(cond, o), self.tangent.where(cond, 0.0))


def lift_tangent_plain(cfg: ModelConfig, U: torch.Tensor,
                       beta: torch.Tensor, dU: torch.Tensor,
                       dbeta: torch.Tensor):
    """The plain version of K9T: :func:`.lift.lift_plain` on
    :class:`Dual` numbers, the lift of the ``(P, n_spikes + 1)`` points
    ``U`` under the ``(P,)`` rates ``beta`` and its tangents along ``D``
    directions (``dU`` ``(D, P, n_spikes + 1)``, ``dbeta`` ``(D, P)``).
    Returns ``(v0, s0, dv0, ds0)``: ``(P, N)`` and ``(D, P, N)``."""
    v, s = lift_plain(cfg, Dual(beta[:, None], dbeta[..., None]),
                      Dual(U, dU))
    shape = (dU.shape[0], *v.value.shape)
    return (v.value, s.value, v.tangent.expand(shape).contiguous(),
            s.tangent.expand(shape).contiguous())


@torch.library.custom_op("atorch::lift_tangent", mutates_args=(),
                         device_types="cuda")
def lift_tangent_op(cfg: str, U: torch.Tensor, beta: torch.Tensor,
                    dU: torch.Tensor, dbeta: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """K9T as an op: :func:`lift_op`'s ``(v0, s0)`` and their tangents
    ``(dv0, ds0)``, each ``(D, P, n_neurons)``, along the ``D`` directions
    ``dU`` ``(D, P, n_spikes + 1)`` and ``dbeta`` ``(D, P)``, in one
    launch.  Its CUDA kernel launches K9T (float64 only) on the current
    stream (no synchronise) and raises on any input the kernel does not
    take; its CPU kernel is the plain version, :func:`lift_tangent_plain`.
    Its primal outputs equal :func:`lift_op`'s bit for bit (the same
    kernel body)."""
    global TANGENT_LAUNCHES
    c = config_of(cfg)
    D = check_tangent_inputs(c, U, beta, dU, dbeta)
    if U.dtype != torch.float64:
        raise ValueError("the lift's tangents on the card (K9T) are float64 "
                         f"only, as the tangent replay's; got {U.dtype}: "
                         "pass dtype='float64'")
    P, N, M, stride = _kernel_inputs(c, U, beta)
    dU, dbeta = dU.contiguous(), dbeta.contiguous()
    v0 = torch.empty(P, N, dtype=U.dtype, device=U.device)
    s0 = torch.empty_like(v0)
    dv0 = torch.empty(D, P, N, dtype=U.dtype, device=U.device)
    ds0 = torch.empty_like(dv0)
    _build.launch(_build.entry("atorch_lift_tangent_f64"),
                  "lift tangent kernel launch", U.device.index,
                  U.data_ptr(), beta.data_ptr(), dU.data_ptr(),
                  dbeta.data_ptr(), v0.data_ptr(), s0.data_ptr(),
                  dv0.data_ptr(), ds0.data_ptr(), P, N, M, D, stride,
                  *_constants(c))
    TANGENT_LAUNCHES += 1
    return v0, s0, dv0, ds0


@lift_tangent_op.register_kernel("cpu")
def _lift_tangent_cpu(cfg, U, beta, dU, dbeta):
    c = config_of(cfg)
    check_tangent_inputs(c, U, beta, dU, dbeta)
    return lift_tangent_plain(c, U, beta, dU, dbeta)


@lift_tangent_op.register_fake
def _lift_tangent_fake(cfg, U, beta, dU, dbeta):
    N = config_of(cfg).n_neurons
    primal = (U.shape[0], N)
    tangent = (dU.shape[0], U.shape[0], N)
    return (U.new_empty(primal), U.new_empty(primal), U.new_empty(tangent),
            U.new_empty(tangent))


def _lift_tangent_vmap(info, in_dims, cfg, U, beta, dU, dbeta):
    """The vmap rule of ``atorch::lift_tangent``: a batch of ``B``
    tangents ``dU`` ``(B, D, P, M + 1)`` and ``dbeta`` ``(B, D, P)``
    (either unbatched, then shared by the batch) runs as ONE op call of
    ``B * D`` directions; the tangents come back ``(B, D, P, N)`` and the
    primal outputs unbatched.  The primal inputs cannot be batched (a batch
    of points is a ``(P, n_spikes + 1)`` stack)."""
    _, dims_U, dims_b, dims_dU, dims_db = in_dims
    if dims_U is not None or dims_b is not None:
        raise NotImplementedError(
            "vmap over the lift tangent's U or beta: only the tangents dU "
            "and dbeta can be batched (lift a batch of points as one stack)")
    B = info.batch_size

    def fold(x, dim):
        x = x.expand(B, *x.shape) if dim is None else x.movedim(dim, 0)
        return x.reshape(B * x.shape[1], *x.shape[2:])

    out = lift_tangent_op(cfg, U, beta, fold(dU, dims_dU),
                          fold(dbeta, dims_db))
    return ((*out[:2], *(t.reshape(B, -1, *t.shape[1:]) for t in out[2:])),
            (None, None, 0, 0))


torch.library.register_vmap("atorch::lift_tangent", _lift_tangent_vmap)


def lift_tangent(cfg: ModelConfig, U: torch.Tensor, beta: torch.Tensor,
                 dU: torch.Tensor, dbeta: torch.Tensor):
    """The op ``atorch::lift_tangent`` on tensors of any device (K9T for
    CUDA ones, :func:`lift_tangent_plain` for CPU ones): ``(v0, s0, dv0,
    ds0)``."""
    return lift_tangent_op(config_key(cfg), U, beta, dU, dbeta)
