"""A :class:`RankPool` on the cards: one NCCL rank a card, rank 0 in the
test process on card 0, ranks that outlive a call.  The pool's map is the
unsharded map on card 0 within the f32 bar, a sweep of the CLI on it is
the unsharded sweep's, and a rank that raises ends the call with its
traceback, the card's queue free again.

Every test here needs two CUDA cards or more and skips with fewer.  The
file and its workers import no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rank_pool_cuda.py -m cuda
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_shard_workers as workers  # noqa: E402
import armadillocudalinearinterpolation_torch as pt  # noqa: E402
from armadillocudalinearinterpolation_torch.cli import driver  # noqa: E402
from armadillocudalinearinterpolation_torch.parallel import RankPool  # noqa: E402
from armadillocudalinearinterpolation_torch.utils.checkpoint import (  # noqa: E402
    ContinuationCheckpoint)

pytestmark = pytest.mark.cuda

INITIAL_GUESS = (0.3310, 0.6914, 1.3557)
F32_BAR = 2e-5            # the f32 residual bar (PERF.md section 2)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more: one NCCL rank a card")
    return min(torch.cuda.device_count(), 4)


def test_the_pool_maps_on_every_card(cards):
    """Config 3's shapes at R=256 (f32, W=128) over a rank a card: every
    rank the same ``f``, K1 launched on every card, within the f32 bar of
    the unsharded map; the ranks the same processes after two calls."""
    cfg = pt.ModelConfig(n_neurons=1024, n_real=256, dtype="float32",
                         evolve_window=128)
    params = pt.MapParams.create(13.0589, 0.1, dtype="float32")
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float32)
    with RankPool(cards, "cuda", timeout_s=120.0) as pool:
        assert pool.backend == "nccl"
        pids = pool.pids
        outs = pool.gather(workers.card_map, cfg, params, 0, z)
        where = pool.gather(workers.whereabouts)
        assert pool.pids == pids
    assert not dist.is_initialized()
    assert [w["device"] for w in where] == [f"cuda:{r}"
                                            for r in range(cards)]
    _, p, beta = workers.card_draw(cfg, params, 0)
    want = pt.event_driven_map(cfg, p, beta, z.to("cuda")).cpu()
    for out in outs:
        assert out["backend"] == "nccl" and out["launches"]["k1"] > 0
        assert torch.equal(out["f"], outs[0]["f"])
    assert float((outs[0]["f"] - want).abs().max()) <= F32_BAR


def test_a_sweep_on_the_pool_is_the_unsharded_sweep(cards, tmp_path):
    """Driver.cu's f32 sweep (N=512, R=1000, FD 3e-4, 3 steps,
    ``--stability``) on the pool, against the same sweep on card 0."""
    argv = ["--neurons", "512", "--realisations", "1000", "--sigma", "0.1",
            "--evolve-window", "128", "--fd-eps", "3e-4", "--steps", "3",
            "--stability", "--quiet"]
    assert driver.main(argv + ["--checkpoint", str(tmp_path / "u")]) == 0
    with RankPool(cards, "cuda", timeout_s=120.0) as pool:
        assert driver.main(argv + ["--shard", str(cards), "--checkpoint",
                                   str(tmp_path / "s")], pool=pool) == 0
    u = ContinuationCheckpoint(str(tmp_path / "u")).load_all()
    s = ContinuationCheckpoint(str(tmp_path / "s")).load_all()
    assert [x.index for x in s] == [x.index for x in u] == [0, 1, 2]
    for a, b in zip(s, u):
        assert a.converged and b.converged and a.n_unstable == b.n_unstable
        np.testing.assert_allclose(a.solution, b.solution, rtol=0,
                                   atol=F32_BAR)


@pytest.mark.parametrize("rank", [1, 0])
def test_a_rank_that_raises_ends_the_call(cards, rank):
    """Rank ``rank`` raises while the others wait in NCCL's all-reduce:
    the call raises its traceback well inside the group's timeout, the
    other ranks are gone, rank 0's group is aborted, and card 0 runs
    work again."""
    timeout = 60.0
    pool = RankPool(cards, "cuda", timeout_s=timeout)
    assert pool.run(workers.reduce_twice, 8).tolist() == [float(cards)] * 3
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=f"rank{rank} failed first:"
                       "(.|\n)*fails on purpose"):
        pool.run(workers.raise_on_rank, 8, rank)
    assert time.perf_counter() - t0 < timeout / 2
    assert pool.closed and not dist.is_initialized()
    assert all(p.exitcode is not None for p in pool._procs)

    def work():
        x = torch.ones(1024, device="cuda")
        float(x.sum())
    done = threading.Thread(target=work, daemon=True)
    done.start()
    done.join(timeout=30.0)
    assert not done.is_alive(), "card 0's queue is still held"
