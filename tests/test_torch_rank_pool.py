"""A :class:`RankPool` on the CPU: gloo ranks that outlive a call, with the
test process as rank 0.

The CLI's sweeps run on the pool through ``cli.driver.main(argv,
pool=...)``: two back to back on the same ranks, the first against the
unsharded sweep and against the benchmark's plain reference
(``benchmark/reference/edmap.py``, float64) at the answers it reported.
A rank that raises ends the call with its traceback and leaves no
process; closing, or dropping the pool, joins every rank; a caller that
dies takes its ranks with it; ``run_ranks`` is one call on a pool of its
own.  The other ranks run ``tests/torch_shard_workers.py``.
"""

import gc
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_shard_workers as workers
import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.cli import driver
from armadillocudalinearinterpolation_torch.parallel import (RankPool,
                                                             run_ranks,
                                                             sharding)
from armadillocudalinearinterpolation_torch.utils.checkpoint import (
    ContinuationCheckpoint)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark.reference import edmap  # noqa: E402

torch.set_num_threads(1)

# Driver.cu's f32 sweep at N=512 from a converged point, R=8 on 2 ranks
SWEEP = ["--cpu", "--neurons", "512", "--realisations", "8", "--sigma",
         "0.1", "--fd-eps", "3e-4", "--evolve-window", "128", "--guess",
         "0.32624", "0.71924", "1.36913", "--stability", "--quiet"]
F32_BAR = 2e-5           # the f32 residual bar (PERF.md section 2)


def steps(path):
    return ContinuationCheckpoint(str(path)).load_all()


class TestOnePool:
    """Calls on one pool of two ranks, started under a profiler."""

    @pytest.fixture(scope="class")
    def pool(self):
        from torch.profiler import profile
        with profile() as prof:
            p = RankPool(2, "cpu", timeout_s=120.0)
            p.run(workers.reduce_twice, 8)
        p.span_names = {e.name for e in prof.events()}
        with p:
            yield p

    def test_sweeps_equal_the_unsharded_sweep_and_the_reference(
            self, pool, tmp_path):
        pids = pool.pids
        argv = SWEEP + ["--steps", "2", "--seed", "5"]
        assert driver.main(argv + ["--checkpoint", str(tmp_path / "u")]) == 0
        assert driver.main(argv + ["--shard", "2", "--checkpoint",
                                   str(tmp_path / "s")], pool=pool) == 0
        assert driver.main(SWEEP + ["--steps", "1", "--seed", "6",
                                    "--shard", "2", "--checkpoint",
                                    str(tmp_path / "t")], pool=pool) == 0
        assert pool.pids == pids and all(p.is_alive() for p in pool._procs)
        assert [s.index for s in steps(tmp_path / "t")] == [0]

        u, s = steps(tmp_path / "u"), steps(tmp_path / "s")
        assert [x.index for x in s] == [x.index for x in u] == [0, 1]
        for a, b in zip(s, u):
            assert a.converged and b.converged
            assert a.n_unstable == b.n_unstable
            np.testing.assert_allclose(a.solution, b.solution, rtol=0,
                                       atol=1e-6)

        cfg = pt.ModelConfig(n_neurons=512, n_real=8, evolve_window=128)
        model = edmap.Model(**{k: getattr(cfg, k)
                               for k in edmap.Model._fields})
        draw = driver.step_draws(cfg, 5, "cpu")
        for x in s:
            rates = draw(x.index, pt.MapParams.create(x.beta, 0.1))
            f = edmap.residual(model, torch.tensor(x.solution)[None],
                               torch.tensor([x.beta], dtype=torch.float64),
                               rates.double()[None])
            gap = abs(float(torch.linalg.vector_norm(f)) - x.residual_norm)
            assert gap <= F32_BAR, (x.index, gap)

    def test_counts_its_all_reduces(self, pool):
        before = sharding.ALL_REDUCES, sharding.ALL_REDUCE_BYTES
        assert pool.run(workers.reduce_twice, 8).tolist() == [2.0] * 3
        assert (sharding.ALL_REDUCES - before[0],
                sharding.ALL_REDUCE_BYTES - before[1]) == (2, 48)

    def test_spans_its_start_and_calls(self, pool):
        assert {"parallel.start", "parallel.dispatch", "parallel.collect",
                "parallel.all_reduce"} <= pool.span_names

    def test_every_rank_is_its_own_process(self, pool):
        ranks = pool.gather(workers.whereabouts)
        assert [r["rank"] for r in ranks] == [0, 1]
        assert [r["pid"] for r in ranks] == [os.getpid()] + pool.pids

    def test_a_call_that_does_not_pickle_leaves_it_open(self, pool):
        with pytest.raises(Exception, match="pickle"):
            driver.main(SWEEP + ["--shard", "2"], pool=pool,
                        draw=lambda step, params: None)
        assert not pool.closed
        assert pool.run(workers.reduce_twice, 8).tolist() == [2.0] * 3

    def test_the_cli_refuses_a_pool_of_another_size(self, pool, capsys):
        assert driver.main(SWEEP + ["--shard", "4"], pool=pool) == 2
        assert "a pool of 2 rank(s)" in capsys.readouterr().err


@pytest.mark.parametrize("rank", [1, 0])
def test_a_rank_that_raises_ends_the_call(rank):
    """Rank ``rank`` raises while the other waits in the all-reduce: the
    call raises its traceback well inside the group's timeout, every
    other rank is gone and the pool is closed."""
    timeout = 60.0
    pool = RankPool(2, "cpu", timeout_s=timeout)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=f"rank{rank} failed first:"
                       "(.|\n)*fails on purpose"):
        pool.run(workers.raise_on_rank, 4, rank)
    assert time.perf_counter() - t0 < timeout / 4
    assert pool.closed and not dist.is_initialized()
    assert all(p.exitcode is not None for p in pool._procs)
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(workers.reduce_twice, 4)


def test_run_ranks_is_one_call_on_a_pool_of_its_own(tmp_path):
    """Every rank's result, rank 0 in this process; no group and no
    store left behind; a world of one runs here alone."""
    ranks = run_ranks(workers.whereabouts, 2, device="cpu",
                      workdir=str(tmp_path))
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["pid"] == os.getpid() != ranks[1]["pid"]
    assert not dist.is_initialized() and not any(tmp_path.iterdir())
    alone = run_ranks(workers.reduce_twice, 1, 2, device="cpu")
    assert [t.tolist() for t in alone] == [[1.0] * 3]


def test_close_joins_every_rank():
    pool = RankPool(3, "cpu", timeout_s=60.0)
    assert pool.run(workers.reduce_twice, 6).tolist() == [3.0] * 3
    pool.close()
    assert [p.exitcode for p in pool._procs] == [0, 0]
    assert not dist.is_initialized()
    pool.close()


def test_a_pool_dropped_unclosed_stops_its_ranks():
    pool = RankPool(2, "cpu", timeout_s=60.0)
    procs = pool._procs
    del pool
    gc.collect()
    assert [p.exitcode for p in procs] == [0]
    assert not dist.is_initialized()


CALLER = textwrap.dedent("""
    import sys, time
    sys.path[:0] = {path!r}
    from armadillocudalinearinterpolation_torch.parallel import RankPool
    if __name__ == "__main__":
        pool = RankPool(3, "cpu")
        print(" ".join(map(str, pool.pids)), flush=True)
        time.sleep(300)
""")


def test_a_caller_that_dies_leaves_no_rank(tmp_path):
    script = tmp_path / "caller.py"
    script.write_text(CALLER.format(path=[str(ROOT)]))
    caller = subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE, text=True)
    try:
        pids = [int(p) for p in caller.stdout.readline().split()]
    finally:
        caller.send_signal(signal.SIGKILL)
        caller.wait()
    assert len(pids) == 2

    def alive(pid):
        # a rank whose caller is gone is reaped by init: not a zombie
        try:
            return "State:\tZ" not in Path(f"/proc/{pid}/status").read_text()
        except FileNotFoundError:
            return False
    deadline = time.monotonic() + 30.0
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not any(alive(p) for p in pids)
