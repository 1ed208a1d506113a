"""The lift's ops on the CPU (``model/lift_cuda.py``): ``atorch::lift``
and ``atorch::lift_tangent``, whose CPU kernels are the plain versions of
K9 and K9T (``csrc/lift.cu``), against the JAX package's ``lift`` and
``jax.jvp`` of it, on a stack of points with their own mean rates, inputs
made from a seed with numpy; ``torch.library.opcheck`` of both ops; the
plain tangents against ``torch.func`` over the plain lift; and
``torch.func.jvp``, ``torch.func.jacfwd`` and ``torch.autograd.forward_ad``
through :class:`.autodiff.DifferentiableLift` against
:func:`.emap.lift_tangents`; the vmap rules.

Relative errors are ``max |a - b| / max |b|`` per output and direction.
The JAX lift runs in XLA on the CPU, whose ``exp`` and forward rules round
otherwise than PyTorch's, and next to a spike the closed forms cancel
(``exp(x/c (1 - beta)) - exp(u (1 - beta))`` and the like), which
magnifies that rounding.  Bars, with what these inputs measure:
- f64 lift 1e-12 (4e-14 to 6e-14);
- f32 lift 1e-5: each f32 lift, XLA's and PyTorch's, sits 1.7e-5 to
  2.2e-5 from the f64 lift at the site next to a spike, and the two are
  1.6e-6 to 1.9e-6 apart, so two f32 evaluations with different ``exp``
  cannot be held to 1e-6 (K9 is, against the plain lift on the card: the
  same operations in the same order, ``tests/test_torch_lift_cuda.py``);
- tangents 2e-12: ``jax.jvp`` and ``torch.func`` (which the CPU kernel
  equals bit for bit, below) differ by up to 1.21e-12 of the largest
  tangent, at the site next to spike 1, along ``U``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from torch_parity import INITIAL_GUESS, configs, jx, pt
from armadillocudalinearinterpolation_torch.model import (autodiff, emap,
                                                          lift_cuda)
from armadillocudalinearinterpolation_torch.model.lift import lift_plain

P = 3
BARS = {"float64": 1e-12, "float32": 1e-5}
JVP_BAR = 2e-12
SAME_RTOL = 1e-12                # two routes of the port, one arithmetic
ROUTES = ("func_jvp", "func_jacfwd", "forward_ad")


def rel(a, b) -> float:
    a, b = (torch.tensor(np.asarray(x), dtype=torch.float64)
            for x in (a, b))
    return float((a - b).abs().max() / b.abs().max())


def points(seed=0, n=P):
    """``n`` points ``U = (c, 0, z_1, z_2)`` around the Driver.cu guess and
    their mean rates, as numpy float64."""
    rng = np.random.default_rng(seed)
    z = np.asarray(INITIAL_GUESS) + rng.uniform(-0.05, 0.05, (n, 3))
    U = np.concatenate([z[:, :1], np.zeros((n, 1)), z[:, 1:]], axis=1)
    return U, 13.0589 + rng.uniform(-0.5, 0.5, n)


def directions(D, along, seed=1):
    """``D`` numpy directions ``(dU, dbeta)``: along ``U``, ``beta`` or
    both (the other zero)."""
    rng = np.random.default_rng(seed)
    dU = rng.standard_normal((D, P, 4))
    db = rng.standard_normal((D, P))
    if along == "U":
        db[:] = 0.0
    elif along == "beta":
        dU[:] = 0.0
    return dU, db


def jax_lift(jcfg):
    """The JAX lift of a stack of points, each with its own rate."""
    def one(u, b):
        return jx.lift(jcfg, jx.MapParams(beta=b, sigma=jnp.zeros_like(b)),
                       u)
    return jax.vmap(one)


@pytest.mark.parametrize("N", [256, 500])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lift_op_matches_jax(dtype, N):
    jcfg, pcfg = configs(dtype=dtype, n_neurons=N, n_real=2)
    U, beta = points()
    np_dt = np.float64 if dtype == "float64" else np.float32
    vj, sj = jax_lift(jcfg)(jnp.asarray(U, np_dt), jnp.asarray(beta, np_dt))
    vp, sp = torch.ops.atorch.lift(lift_cuda.config_key(pcfg),
                                   torch.tensor(U, dtype=pcfg.torch_dtype),
                                   torch.tensor(beta,
                                                dtype=pcfg.torch_dtype))
    assert vp.shape == sp.shape == (P, N) and vp.dtype == pcfg.torch_dtype
    assert rel(vp, vj) <= BARS[dtype]
    assert rel(sp, sj) <= BARS[dtype]


@pytest.mark.parametrize("along", ["U", "beta", "both"])
@pytest.mark.parametrize("D", [1, 3, 4])
def test_lift_tangent_op_matches_jax_jvp(D, along):
    jcfg, pcfg = configs(n_neurons=256, n_real=2)
    U, beta = points()
    dU, db = directions(D, along)
    lift_j = jax_lift(jcfg)
    want = [jax.jvp(lift_j, (jnp.asarray(U), jnp.asarray(beta)),
                    (jnp.asarray(dU[d]), jnp.asarray(db[d])))
            for d in range(D)]
    v0, s0, dv0, ds0 = torch.ops.atorch.lift_tangent(
        lift_cuda.config_key(pcfg), *(torch.tensor(x) for x in (U, beta, dU,
                                                               db)))
    assert dv0.shape == ds0.shape == (D, P, 256)
    assert rel(v0, want[0][0][0]) <= BARS["float64"]
    assert rel(s0, want[0][0][1]) <= BARS["float64"]
    for d, (_, (dvj, dsj)) in enumerate(want):
        assert rel(dv0[d], dvj) <= JVP_BAR, d
        assert rel(ds0[d], dsj) <= JVP_BAR, d


def test_plain_tangents_equal_torch_func_over_the_plain_lift():
    """The dual numbers of the CPU kernel take PyTorch's forward rules in
    PyTorch's order: the tangents of ``torch.func.jvp`` over the plain
    lift, bit for bit, and the primal of the plain lift."""
    _, pcfg = configs(n_neurons=256, n_real=2)
    U, beta, dU, db = (torch.tensor(x) for x in (*points(),
                                                 *directions(3, "both")))

    def lift_of(u, b):
        return lift_plain(pcfg, b[:, None], u)
    v0, s0, dv0, ds0 = lift_cuda.lift_tangent_plain(pcfg, U, beta, dU, db)
    want = torch.func.vmap(
        lambda a, b: torch.func.jvp(lift_of, (U, beta), (a, b))[1])(dU, db)
    for got, ref in zip((v0, s0, dv0, ds0), (*lift_of(U, beta), *want)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("op", ["lift", "lift_f32", "lift_shared_rate",
                                "lift_tangent"])
def test_opcheck(op):
    """torch.library.opcheck of K9's and K9T's ops (their CPU kernels:
    schema, fake kernel, autograd registration, tracing); one rate
    expanded over the points is taken as it is."""
    dtype = torch.float32 if op == "lift_f32" else torch.float64
    _, pcfg = configs(dtype=str(dtype)[6:], n_neurons=256, n_real=2)
    U, beta = (torch.tensor(x, dtype=dtype) for x in points())
    if op == "lift_shared_rate":
        beta = beta[:1].expand(P)
    args = (lift_cuda.config_key(pcfg), U, beta)
    fn = lift_cuda.lift_op
    if op == "lift_tangent":
        fn = lift_cuda.lift_tangent_op
        args += tuple(torch.tensor(x) for x in directions(3, "both"))
    result = torch.library.opcheck(fn, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_ops_refuse_what_the_kernels_do_not_take():
    _, pcfg = configs(n_neurons=256, n_real=2)
    key = lift_cuda.config_key(pcfg)
    U, beta = (torch.tensor(x) for x in points())
    dU, db = (torch.tensor(x) for x in directions(2, "both"))
    with pytest.raises(ValueError, match="U must be"):
        torch.ops.atorch.lift(key, U[:, :3], beta)
    with pytest.raises(ValueError, match="beta must be"):
        torch.ops.atorch.lift(key, U, beta.float())
    with pytest.raises(ValueError, match="dU must be"):
        torch.ops.atorch.lift_tangent(key, U, beta, dU[:, :2], db)
    with pytest.raises(ValueError, match="dbeta must be"):
        torch.ops.atorch.lift_tangent(key, U, beta, dU, db[:1])


def along_route(route, f, U, beta, dU, db):
    """The tangents of ``f(U, beta)`` along one direction by ``route``."""
    if route == "func_jvp":
        return torch.func.jvp(f, (U, beta), (dU, db))[1]
    if route == "forward_ad":
        with fwAD.dual_level():
            out = f(fwAD.make_dual(U, dU), fwAD.make_dual(beta, db))
            return tuple(fwAD.unpack_dual(x).tangent for x in out)
    jv, js = (torch.func.jacfwd(lambda u, b: f(u, b)[k], argnums=(0, 1))(
        U, beta) for k in range(2))
    return tuple(torch.tensordot(j[0], dU, dims=2)
                 + torch.tensordot(j[1], db, dims=1) for j in (jv, js))


@pytest.mark.parametrize("route", ROUTES)
def test_function_routes_equal_lift_tangents(route):
    """torch.func.jvp, torch.func.jacfwd and forward_ad through the
    Function (the ops' CPU kernels) against emap.lift_tangents, which
    takes every direction in one op call; the Function's primal is the
    plain lift's."""
    _, pcfg = configs(n_neurons=256, n_real=2)
    U, beta = (torch.tensor(x) for x in points())
    dU, db = (torch.tensor(x) for x in directions(2, "both"))
    Z = emap.u_to_z(U)
    dU[:, :, 1] = 0.0            # the gauge: spike 1 stays at offset 0
    params = pt.MapParams(beta=beta, sigma=torch.zeros(P, dtype=U.dtype))
    _, _, v0, s0, dv0, ds0 = emap.lift_tangents(
        pcfg, params, Z, emap.u_to_z(dU), db[..., None])
    key = lift_cuda.config_key(pcfg)

    def f(u, b):
        return autodiff.DifferentiableLift.apply(u, b, key)
    assert all(torch.equal(a, b) for a, b in zip(f(U, beta), (v0, s0)))
    for d in range(2):
        dv, ds = along_route(route, f, U, beta, dU[d], db[d])
        assert rel(dv, dv0[d]) <= SAME_RTOL, d
        assert rel(ds, ds0[d]) <= SAME_RTOL, d


def test_vmap_folds_directions_and_refuses_points():
    """Under vmap the tangent op folds a batch of directions into D, equal
    to the unbatched call; a batch of points, through the op or the
    Function, is refused (a stack is one call)."""
    _, pcfg = configs(n_neurons=256, n_real=2)
    key = lift_cuda.config_key(pcfg)
    U, beta = (torch.tensor(x) for x in points())
    dU, db = (torch.tensor(x) for x in directions(4, "both"))
    whole = torch.ops.atorch.lift_tangent(key, U, beta, dU, db)
    by_pairs = torch.func.vmap(
        lambda a, b: torch.ops.atorch.lift_tangent(key, U, beta, a, b),
        out_dims=(None, None, 0, 0))(dU.reshape(2, 2, P, 4),
                                     db.reshape(2, 2, P))
    for a, b in zip(by_pairs, whole):
        assert torch.equal(a.reshape(b.shape), b)
    stacks = torch.stack([U, U + 0.01])
    with pytest.raises(NotImplementedError, match="U or beta"):
        torch.func.vmap(
            lambda u: torch.ops.atorch.lift_tangent(key, u, beta, dU, db))(
                stacks)
    with pytest.raises(NotImplementedError, match="one"):
        torch.func.vmap(lambda u: autodiff.DifferentiableLift.apply(
            u, beta, key))(stacks)


def test_lift_on_the_cpu_is_the_plain_loop():
    """On CPU tensors ``lift`` runs the plain loop, for one point, a stack
    with one rate and a stack with a rate a point (``point_params``)."""
    _, pcfg = configs(n_neurons=256, n_real=2)
    U, beta = (torch.tensor(x) for x in points())
    shared = pt.MapParams.create(13.0589, 0.1, dtype="float64")
    own = emap.point_params(pt.MapParams(beta=beta, sigma=beta * 0), P)
    for params, u, b in ((shared, U[0], shared.beta),
                         (shared, U, shared.beta), (own, U, beta[:, None])):
        got = pt.lift(pcfg, params, u)
        want = lift_plain(pcfg, b, u)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
