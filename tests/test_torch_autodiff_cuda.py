"""The port's map under PyTorch's forward-mode AD on the card: the evolve's
``autograd.Function`` s with K1, K2 and K2T as ops (``model/autodiff.py``).

``torch.autograd.forward_ad``, ``torch.func.jacfwd`` and ``jacfwd_cols``
over the map against ``F.value_and_jacobian`` (before the ops, forward AD
on the card kept only the lift's term of the residual, silently, and
``torch.func`` raised on the kernels' data pointers); one K2T launch a
``jacfwd``; a map evaluation without a tangent launching as it did; and
each op's CUDA kernel against its CPU kernel (the plain version) on the
same inputs.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_autodiff_cuda.py -m cuda
"""

import pytest
import torch
import torch.autograd.forward_ad as fwAD

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.model import (autodiff,
                                                          evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.replay import (
    compute_schedule)

pytestmark = pytest.mark.cuda

Z_REF = (0.3262, 0.7194, 1.3690)
# one log replayed by the same kernel: relative to the largest entry
SAME_RTOL = 1e-12
CONFIG4 = (4096, 64)
WALKERS = (512, 4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def residual(dev, N, R, backend):
    cfg = pt.ModelConfig(n_neurons=N, n_real=R, dtype="float64")
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64", device=dev)
    return pt.make_residual_fn(cfg, params, 0, device=dev,
                               evolve_backend=backend)


def counts():
    return (evolve_cuda.LAUNCHES, replay_cuda.LAUNCHES,
            replay_cuda.TANGENT_LAUNCHES)


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("backend", ["auto", "replay"])
@pytest.mark.parametrize("shape", [WALKERS, CONFIG4],
                         ids=["N512_R4", "N4096_R64"])
def test_forward_ad_and_jacfwd_match_value_and_jacobian(card, shape,
                                                        backend):
    """forward_ad column by column, jacfwd and jacfwd_cols against the
    exact Jacobian at 1e-12 relative; jacfwd launches K1 once and K2T once
    for all three columns (and K2 once on the replay)."""
    F = residual(card, *shape, backend)
    Z = torch.tensor(Z_REF, dtype=torch.float64, device=card)
    f, J = F.value_and_jacobian(Z)
    cols = []
    for e in torch.eye(3, dtype=torch.float64, device=card):
        with fwAD.dual_level():
            out = F(fwAD.make_dual(Z, e))
            primal, tangent = fwAD.unpack_dual(out)
        assert torch.equal(primal, f)
        cols.append(tangent)
    assert rel(torch.stack(cols, dim=1), J) <= SAME_RTOL
    before = counts()
    Jf = torch.func.jacfwd(F)(Z)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(counts(), before))
    assert launched == ((1, 1, 1) if backend == "replay" else (1, 0, 1))
    assert rel(Jf, J) <= SAME_RTOL
    assert rel(pt.jacfwd_cols(F)(Z), J) <= SAME_RTOL


def test_map_without_a_tangent_launches_as_before(card, monkeypatch):
    """F(Z) and F of a stack launch K1 once each with no log and no time
    log, and nothing else; with a tangent, one K1 with both logs and one
    K2T."""
    calls = []
    real = evolve_cuda.evolve_op

    def spy(cfg, v0, s0, beta, ii, R, E, times, fallbacks):
        calls.append((E, times))
        return real(cfg, v0, s0, beta, ii, R, E, times, fallbacks)
    monkeypatch.setattr(evolve_cuda, "evolve_op", spy)
    F = residual(card, *WALKERS, "auto")
    Z = torch.tensor(Z_REF, dtype=torch.float64, device=card)
    before = counts()
    F(Z)
    F(torch.stack([Z, Z + 1e-3]))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 0, 0)
    assert calls == [(0, False), (0, False)]
    torch.func.jvp(F, (Z,), (torch.ones_like(Z),))
    assert len(calls) == 3 and calls[2][0] > 0 and calls[2][1]
    assert tuple(a - b for a, b in zip(counts(), before)) == (3, 0, 1)


def small_inputs(dev):
    """The three ops' inputs at the walkers' N=512, R=4 (f64, sigma 0.1)
    on ``dev``: the lift of Z_REF, the draw, the fp64 evolve's log and
    time log, the f32 discovery's log, and D=3 random directions."""
    F = residual(dev, *WALKERS, "torch")
    cfg = F.cfg
    Z = torch.tensor([Z_REF], dtype=torch.float64, device=dev)
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, F.params, pt.z_to_u(Z)))
    ii = pt.initial_spike_indices(cfg, Z).contiguous()
    gen = torch.Generator(dev).manual_seed(3)
    dv, ds = (torch.randn(3, 1, cfg.n_neurons, generator=gen,
                          dtype=torch.float64, device=dev) for _ in range(2))
    return cfg, v0, s0, F.beta, ii, dv, ds


@pytest.mark.parametrize("op", ["evolve", "replay", "replay_tangent",
                                "replay_tangent_logged"])
def test_op_cuda_and_cpu_kernels_agree(card, op):
    """Each op on CUDA tensors (its kernel) and on their CPU copies (the
    plain version): K1 every row's indices equal, times within 1e-9 (the
    kernel-vs-plain f64 bar; the two sides' exp differ in the last bits);
    K2 and K2T times within 1e-12, K2T's tangents within 1e-12 relative."""
    cfg, v0, s0, beta, ii, dv, ds = small_inputs(card)
    key = evolve_cuda.config_key(cfg)
    R = cfg.n_real
    dp = torch.zeros(3, 1, dtype=torch.float64, device=card)
    if op == "evolve":
        args = (key, v0, s0, beta, ii, R, 1024, True, False)
        fn, tol = torch.ops.atorch.evolve, 1e-9
    else:
        res, sched, times = autodiff.direct_schedule(
            cfg, evolve_cuda.evolve_ensemble_cuda, v0, s0, beta, ii)
        n_ev = res.n_events
        if op == "replay":
            sched, n_ev = compute_schedule(cfg, v0, s0, beta, ii, n_real=R)
            args = (key, sched, n_ev, v0, s0, beta, ii, R)
            fn = torch.ops.atorch.replay
        else:
            if op == "replay_tangent":
                sched, n_ev = compute_schedule(cfg, v0, s0, beta, ii,
                                               n_real=R)
                times = None
            args = (key, sched, n_ev, v0, s0, beta, ii, dv, ds, None, dp,
                    times, R)
            fn = torch.ops.atorch.replay_tangent
        tol = 1e-12
    got = fn(*args)
    want = fn(*(x.cpu() if isinstance(x, torch.Tensor) else x
                for x in args))
    assert all(x.device.type == "cuda" for x in got)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        if not a.is_floating_point():
            assert torch.equal(a, b), i
        elif op.startswith("replay_tangent") and i >= 6:
            assert rel(a, b) <= SAME_RTOL, i
        elif a.numel():
            assert float((a - b).abs().max()) <= tol, i
