"""Ensemble sharding on the card: the ranks of :func:`run_ranks` (the
test process and ranks spawned) run the kernels (K1, K2, K2T) on their
rows, held to the unsharded run on the same card.  Two ranks on one card
take gloo; a world of one takes NCCL.

Every test here needs a CUDA card and skips without one.  The file and
its workers import no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharding_cuda.py -m cuda
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_shard_workers as workers  # noqa: E402
import armadillocudalinearinterpolation_torch as pt  # noqa: E402
from armadillocudalinearinterpolation_torch.parallel import run_ranks  # noqa: E402

pytestmark = pytest.mark.cuda

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)
F32_BAR = 2e-5            # the f32 residual bar (PERF.md section 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def on_ranks(world, name, tmp_path, **kw):
    outs = run_ranks(workers.run_cases, world, [(name, name, kw)],
                     device="cuda", workdir=str(tmp_path))
    return [o[name] for o in outs]


@pytest.mark.parametrize("world, backend", [(2, "gloo"), (1, "nccl")])
def test_sharded_map_on_the_card(card, tmp_path, world, backend):
    """Config 3's shapes at R=256 (f32, W=128): every rank the same ``f``,
    within the f32 bar of the unsharded map, K1 launched on every rank."""
    cfg = pt.ModelConfig(n_neurons=1024, n_real=256, dtype="float32",
                         evolve_window=128)
    params = pt.MapParams.create(13.0589, 0.1, dtype="float32")
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float32)
    outs = on_ranks(world, "card_map", tmp_path, cfg=cfg, params=params,
                    seed=0, Z=z)
    _, p, beta = workers.card_draw(cfg, params, 0)
    want = pt.event_driven_map(cfg, p, beta, z.to(card)).cpu()
    for out in outs:
        assert out["backend"] == backend and out["launches"]["k1"] > 0
        assert torch.equal(out["f"], outs[0]["f"])
    assert float((outs[0]["f"] - want).abs().max()) <= F32_BAR


@pytest.mark.parametrize("stage2", ["frozen-fwd", "exact"])
def test_sharded_staged_solve_on_the_card(card, tmp_path, stage2):
    """N=512, R=16, f64 over 2 ranks: the replay default (K1, K2) and the
    exact stage 2 on the replay (K1, K2T, K2) land within 1e-8 of the
    unsharded solve."""
    cfg = pt.ModelConfig(n_neurons=512, n_real=16, dtype="float64",
                         root_tol=1e-12, max_events=2048)
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64")
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)
    kw = {"tolerance": 1e-8}
    if stage2 == "exact":
        kw["stage2_ncfg"] = pt.NewtonConfig(tolerance=0.9e-8,
                                            max_iterations=8,
                                            fd_mode="exact")
    outs = on_ranks(2, "card_staged", tmp_path, cfg=cfg, params=params,
                    seed=0, Z=z, kw=kw)
    _, p, beta = workers.card_draw(cfg, params, 0)
    want = pt.newton_solve_staged(cfg, p, z.to(card), beta=beta, **kw)
    assert want.converged
    for out in outs:
        assert out["converged"]
        assert torch.equal(out["solution"], outs[0]["solution"])
        assert out["launches"]["k1"] > 0 and out["launches"]["k2"] > 0
        assert (out["launches"]["k2t"] > 0) == (stage2 == "exact")
    assert float((outs[0]["solution"] - want.solution.cpu()).abs().max()) \
        <= 1e-8
