"""The lift's kernels on the card (``csrc/lift.cu``, ``model/lift_cuda.py``):
K9 against the plain lift (``lift_plain``) and K9T against ``torch.func``
over it, on the same CUDA tensors, at P in {1, 4, 7} points, N in {256,
1000, 4096, 10240} sites (1000 is no multiple of the block) and D in {1,
3, 4} directions, f32 and f64; K9T's primal against K9's (bit for bit, the
same body); a map evaluation launching K9 once and nothing else for its
lift; an exact Jacobian launching K9T once for all directions; the rate
read at its stride; and the AD routes through the lift.

Bars: K9 f64 1e-12 and f32 1e-6 relative (``max |a - b| / max |b|``; the
plain lift runs the same operations in the same order, so equal bits are
expected where the two ``exp`` agree); K9T 1e-12 relative a direction.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lift_cuda.py -m cuda
"""

import pytest
import torch
import torch.autograd.forward_ad as fwAD

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.model import emap, lift_cuda
from armadillocudalinearinterpolation_torch.model.lift import lift_plain

pytestmark = pytest.mark.cuda

BARS = {torch.float64: 1e-12, torch.float32: 1e-6}
TANGENT_BAR = 1e-12
GUESS = (0.3310, 0.6914, 1.3557)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def inputs(dev, P, dtype, D=0, seed=0):
    """``P`` points around the Driver.cu guess with their own mean rates,
    and ``D`` random directions, from a seeded generator on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.tensor(GUESS, dtype=torch.float64) + 0.1 * (
        torch.rand(P, 3, generator=gen, dtype=torch.float64) - 0.5)
    U = emap.z_to_u(z)
    beta = 13.0589 + torch.rand(P, generator=gen, dtype=torch.float64) - 0.5
    dU = torch.randn(D, P, 4, generator=gen, dtype=torch.float64)
    db = torch.randn(D, P, generator=gen, dtype=torch.float64)
    return tuple(x.to(device=dev, dtype=dtype) for x in (U, beta, dU, db))


def config(N, dtype):
    return pt.ModelConfig(n_neurons=N, n_real=1,
                          dtype=str(dtype).removeprefix("torch."))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("N", [256, 1000, 4096, 10240])
@pytest.mark.parametrize("P", [1, 4, 7])
def test_k9_matches_the_plain_lift(card, P, N, dtype):
    cfg = config(N, dtype)
    U, beta, _, _ = inputs(card, P, dtype)
    before = lift_cuda.LAUNCHES
    v0, s0 = lift_cuda.lift_op(lift_cuda.config_key(cfg), U, beta)
    torch.cuda.synchronize()
    assert lift_cuda.LAUNCHES == before + 1
    want = lift_plain(cfg, beta[:, None], U)
    assert v0.shape == s0.shape == (P, N) and v0.dtype == dtype
    assert rel(v0, want[0]) <= BARS[dtype]
    assert rel(s0, want[1]) <= BARS[dtype]


@pytest.mark.parametrize("D", [1, 3, 4])
@pytest.mark.parametrize("N", [256, 1000, 4096, 10240])
@pytest.mark.parametrize("P", [1, 4, 7])
def test_k9t_matches_torch_func_over_the_plain_lift(card, P, N, D):
    cfg = config(N, torch.float64)
    U, beta, dU, db = inputs(card, P, torch.float64, D)
    key = lift_cuda.config_key(cfg)
    before = lift_cuda.TANGENT_LAUNCHES
    v0, s0, dv0, ds0 = lift_cuda.lift_tangent_op(key, U, beta, dU, db)
    torch.cuda.synchronize()
    assert lift_cuda.TANGENT_LAUNCHES == before + 1
    k9 = lift_cuda.lift_op(key, U, beta)
    assert torch.equal(v0, k9[0]) and torch.equal(s0, k9[1])

    def lift_of(u, b):
        return lift_plain(cfg, b[:, None], u)
    dv, ds = torch.func.vmap(
        lambda a, b: torch.func.jvp(lift_of, (U, beta), (a, b))[1])(dU, db)
    assert dv0.shape == ds0.shape == (D, P, N)
    for d in range(D):
        assert rel(dv0[d], dv[d]) <= TANGENT_BAR, d
        assert rel(ds0[d], ds[d]) <= TANGENT_BAR, d


@pytest.mark.parametrize("rate", ["shared", "column"])
def test_kernels_read_the_rate_at_its_stride(card, rate):
    """One rate expanded over the points (stride 0, as the map passes it)
    and the rates as a column of a wider tensor (stride 7, as the fold
    solver's extended points give them) read as their contiguous copy."""
    cfg = config(1000, torch.float64)
    U, beta, dU, db = inputs(card, 4, torch.float64, 3)
    if rate == "shared":
        beta = beta[:1].expand(4)
    else:
        wide = torch.zeros(4, 7, dtype=torch.float64, device=card)
        wide[:, 6] = beta
        beta = wide[:, 6]
    assert beta.stride(0) == (0 if rate == "shared" else 7)
    key = lift_cuda.config_key(cfg)
    got = lift_cuda.lift_tangent_op(key, U, beta, dU, db)
    want = lift_cuda.lift_tangent_op(key, U, beta.contiguous(), dU, db)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = lift_cuda.lift_op(key, U, beta)
    want = lift_cuda.lift_op(key, U, beta.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k9t_refuses_float32(card):
    cfg = config(256, torch.float32)
    U, beta, dU, db = inputs(card, 2, torch.float32, 1)
    with pytest.raises(ValueError, match="float64"):
        lift_cuda.lift_tangent_op(lift_cuda.config_key(cfg), U, beta, dU, db)


def test_lift_is_one_launch_and_nothing_else(card):
    """``pt.lift`` of a stack on the card (one rate expanded over the
    points, as the map passes it) launches K9 once, and the profiler sees
    no other device work from it; a map evaluation launches K9 once and
    K9T never."""
    from torch.profiler import ProfilerActivity, profile
    cfg = pt.ModelConfig(n_neurons=1024, n_real=16, dtype="float32")
    params = pt.MapParams.create(13.0589, 0.1, dtype="float32", device=card)
    Z = torch.tensor([GUESS] * 4, dtype=torch.float32, device=card)
    U = pt.z_to_u(Z)
    pt.lift(cfg, emap.point_params(params, 4), U)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pt.lift(cfg, emap.point_params(params, 4), U)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert names and all("lift_kernel" in n for n in names), names
    F = pt.make_residual_fn(cfg, params, 0, device=card)
    counts = (lift_cuda.LAUNCHES, lift_cuda.TANGENT_LAUNCHES)
    F(Z[0])
    F(Z)
    torch.cuda.synchronize()
    assert (lift_cuda.LAUNCHES - counts[0],
            lift_cuda.TANGENT_LAUNCHES - counts[1]) == (2, 0)


@pytest.mark.parametrize("backend", ["auto", "replay"])
def test_exact_jacobian_launches_k9t_once(card, backend):
    """``value_and_jacobian`` takes the lift's three (and with the beta
    column four) directions in one K9T launch and no K9; ``jacfwd`` of
    the map one K9 and one K9T."""
    cfg = pt.ModelConfig(n_neurons=512, n_real=4, dtype="float64")
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64", device=card)
    F = pt.make_residual_fn(cfg, params, 0, device=card,
                            evolve_backend=backend)
    Z = torch.tensor((0.3262, 0.7194, 1.3690), dtype=torch.float64,
                     device=card)
    for call in (lambda: F.value_and_jacobian(Z),
                 lambda: F.value_and_jacobian(Z, param="beta")):
        counts = (lift_cuda.LAUNCHES, lift_cuda.TANGENT_LAUNCHES)
        call()
        torch.cuda.synchronize()
        assert (lift_cuda.LAUNCHES - counts[0],
                lift_cuda.TANGENT_LAUNCHES - counts[1]) == (0, 1)
    counts = (lift_cuda.LAUNCHES, lift_cuda.TANGENT_LAUNCHES)
    torch.func.jacfwd(F)(Z)
    torch.cuda.synchronize()
    assert (lift_cuda.LAUNCHES - counts[0],
            lift_cuda.TANGENT_LAUNCHES - counts[1]) == (1, 1)


@pytest.mark.parametrize("route", ["func_jvp", "func_jacfwd", "forward_ad"])
def test_lift_routes_on_the_card_equal_lift_tangents(card, route):
    """``pt.lift`` of one point under torch.func.jvp, torch.func.jacfwd and
    forward_ad against ``emap.lift_tangents`` (K9T, all directions in one
    launch): the same kernel arithmetic a direction."""
    cfg = pt.ModelConfig(n_neurons=4096, n_real=4, dtype="float64")
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64", device=card)
    Z = torch.tensor(GUESS, dtype=torch.float64, device=card)
    eye = torch.eye(3, dtype=torch.float64, device=card)
    _, _, v0, s0, dv0, ds0 = emap.lift_tangents(
        cfg, params, Z[None], eye[:, None],
        torch.zeros(3, 1, 1, dtype=torch.float64, device=card))

    def lift_of(z):
        return pt.lift(cfg, params, pt.z_to_u(z))
    assert all(torch.equal(a, b[0]) for a, b in zip(lift_of(Z), (v0, s0)))
    if route == "func_jacfwd":
        jv, js = torch.func.jacfwd(lift_of)(Z)
        cols = list(zip(jv.T, js.T))
    elif route == "func_jvp":
        cols = [torch.func.jvp(lift_of, (Z,), (e,))[1] for e in eye]
    else:
        cols = []
        for e in eye:
            with fwAD.dual_level():
                out = lift_of(fwAD.make_dual(Z, e))
                cols.append(tuple(fwAD.unpack_dual(x).tangent for x in out))
    for d, (dv, ds) in enumerate(cols):
        assert rel(dv, dv0[d, 0]) <= TANGENT_BAR, d
        assert rel(ds, ds0[d, 0]) <= TANGENT_BAR, d
