"""The port's ensemble sharding (``parallel/sharding.py``) on the CPU: gloo
ranks (the test process and spawned ones) against the JAX package's two
multi-device routes on its 8-device virtual mesh (``tests/test_sharding.py``,
``tests/test_shard_map.py``), and against the unsharded port.

The ranks run ``tests/torch_shard_workers.py`` (torch and the port only)
and meet at a ``file://`` store under ``tmp_path``.  Bars are the JAX
package's own sharded bars: f64 1e-13, every rank the same ``f``.
"""

import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_parity import INITIAL_GUESS, configs, jax_draw, params, to_torch
import torch_shard_workers as workers
import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_tpu.model.emap import (
    sample_beta as jax_sample_beta)
from armadillocudalinearinterpolation_tpu.parallel import (
    make_mesh, make_shard_map_residual_fn)
from armadillocudalinearinterpolation_tpu.parallel.sharding import (
    event_driven_map_sharded as jax_event_driven_map_sharded)
from armadillocudalinearinterpolation_torch.analysis.branches import (
    enumerate_branches)
from armadillocudalinearinterpolation_torch.analysis.continuation import (
    continue_branch, make_arclength_step)
from armadillocudalinearinterpolation_torch.cli import driver
from armadillocudalinearinterpolation_torch.parallel import (
    choose_backend, run_ranks)
from armadillocudalinearinterpolation_torch.parallel import sharding

BAR = 1e-13


def ranks(world, cases, tmp_path, **kw):
    """``run_cases(cases)`` on ``world`` gloo ranks: one dict per rank."""
    return run_ranks(workers.run_cases, world, cases, device="cpu",
                     workdir=str(tmp_path), **kw)


def same_on_every_rank(outs, name, key="f"):
    first = outs[0][name][key]
    for out in outs[1:]:
        assert torch.equal(out[name][key], first)
    return first


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return make_mesh({"real": 8})


@pytest.fixture(scope="module")
def gspmd_case():
    """N=256, R=16, sigma 0.1, f64 (``tests/test_sharding.py:28-38``), the
    draw of ``PRNGKey(0)`` in both packages."""
    jcfg, pcfg = configs(n_neurons=256, n_real=16)
    jp, pp = params(sigma=0.1)
    return jcfg, pcfg, jp, pp, jax_draw(jcfg, jp)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_map_matches_jax_gspmd(world, gspmd_case, mesh8, tmp_path):
    """The port's sharded map on the JAX draw against JAX's GSPMD map on
    the virtual mesh: 1e-13, every rank the same ``f`` from one
    all-reduce."""
    jcfg, pcfg, jp, pp, draw = gspmd_case
    key = jax.random.PRNGKey(0)
    z = np.asarray(INITIAL_GUESS)
    f_jax = np.asarray(jax.jit(lambda zz: jax_event_driven_map_sharded(
        jcfg, jp, key, zz, mesh8))(jax.numpy.asarray(z)))
    outs = ranks(world, [("map", "sharded_map", dict(
        cfg=pcfg, params=pp, beta=to_torch(draw), Z=to_torch(z)))],
        tmp_path)
    f = same_on_every_rank(outs, "map")
    np.testing.assert_allclose(f.numpy(), f_jax, rtol=0, atol=BAR)
    assert [o["map"]["reduces"] for o in outs] == [1] * world


@pytest.mark.parametrize("world", [2, 4])
def test_per_rank_draws_match_jax_shard_map(world, mesh8, tmp_path):
    """The shard_map route (``tests/test_shard_map.py:19-37``): JAX draws
    each device's rows from ``fold_in(key, i)``; the port takes the draw
    whose row blocks are those draws, and needs no second function."""
    jcfg, pcfg = configs(n_neurons=256, n_real=16)
    jp, pp = params(sigma=0.2)
    key = jax.random.PRNGKey(0)
    local = jcfg.with_(n_real=2)
    draw = np.concatenate([np.asarray(jax_sample_beta(
        local, jp, jax.random.fold_in(key, i))) for i in range(8)])
    z = jax.numpy.asarray(INITIAL_GUESS)
    f_jax = np.asarray(jax.jit(make_shard_map_residual_fn(
        jcfg, jp, key, mesh8))(z))
    outs = ranks(world, [("map", "sharded_map", dict(
        cfg=pcfg, params=pp, beta=to_torch(draw),
        Z=to_torch(INITIAL_GUESS)))], tmp_path)
    f = same_on_every_rank(outs, "map")
    np.testing.assert_allclose(f.numpy(), f_jax, rtol=0, atol=BAR)


def test_uneven_split_equals_unsharded(tmp_path):
    """R=10 over 4 ranks: blocks of 3, 3, 2, 2 rows (no padding), for one
    point and for a stack of points with their own parameters (rows ``p *
    R + r``), equal to the unsharded map."""
    _, pcfg = configs(n_neurons=256, n_real=10)
    _, pp = params(sigma=0.1)
    noise = pt.sample_noise(pcfg, torch.Generator().manual_seed(3))
    beta = pt.beta_from_noise(pcfg, pp, noise)
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float64)
    stack = z[None] + 1e-3 * torch.eye(3, dtype=torch.float64)
    pp3 = pt.MapParams(beta=torch.tensor([13.0, 13.0589, 13.1],
                                         dtype=torch.float64),
                       sigma=torch.full((3,), 0.1, dtype=torch.float64))
    beta3 = pt.beta_from_noise(pcfg, pp3, noise)
    outs = ranks(4, [
        ("one", "sharded_map", dict(cfg=pcfg, params=pp, beta=beta, Z=z)),
        ("stack", "sharded_map", dict(cfg=pcfg, params=pp3, beta=beta3,
                                      Z=stack, P=3))], tmp_path)
    assert [o["one"]["block"] for o in outs] == [(0, 3), (3, 6), (6, 8),
                                                 (8, 10)]
    rows = torch.cat([o["stack"]["rows"] for o in outs])
    assert sorted(rows.tolist()) == list(range(30))
    assert outs[1]["stack"]["rows"].tolist() == [3, 4, 5, 13, 14, 15, 23,
                                                 24, 25]
    for name, params_, beta_, Z in (("one", pp, beta, z),
                                    ("stack", pp3, beta3, stack)):
        f = same_on_every_rank(outs, name)
        want = pt.event_driven_map(pcfg, params_, beta_, Z)
        torch.testing.assert_close(f, want, rtol=0, atol=BAR)


def test_f32_sharded_map_is_the_unsharded_map_bit_for_bit(tmp_path):
    """A float32 map over 2 ranks equals the unsharded one bit for bit:
    the ensemble sums are taken in float64 (``restrict.masked_sums``), so
    splitting the R=512 rows over the ranks reorders no float32 rounding
    (a float32 sum reassociated over the ranks moves ``f``, which an FD
    Jacobian then amplifies by ``1 / eps``)."""
    _, pcfg = configs(dtype="float32", n_neurons=256, n_real=512)
    _, pp = params(sigma=0.1, dtype="float32")
    beta = pt.sample_beta(pcfg, pp, torch.Generator().manual_seed(5))
    z = torch.tensor(INITIAL_GUESS, dtype=torch.float32)
    outs = ranks(2, [("f32", "sharded_map", dict(cfg=pcfg, params=pp,
                                                 beta=beta, Z=z))],
                 tmp_path)
    f = same_on_every_rank(outs, "f32")
    want = pt.event_driven_map(pcfg, pp, beta, z)
    assert f.dtype == torch.float32
    assert torch.equal(f, want), (f - want).abs().max()


def test_world_larger_than_the_ensemble_is_refused(tmp_path):
    """More ranks than realisations: every rank refuses (the counterpart
    of ``tests/test_sharding.py:23``) and the run raises."""
    with pytest.raises(Exception, match="a rank would hold none"):
        ranks(2, [("g", "group_of", dict(n_real=1))], tmp_path)


def test_a_rank_that_raises_ends_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits in the all-reduce: the run ends
    with rank 1's error (the root cause, not rank 0's broken collective)
    well inside the group's timeout, not in a hang."""
    timeout = 60.0
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError,
                       match="rank1 failed first:(.|\n)*fails on purpose"):
        ranks(2, [("r", "raise_on_rank", dict(n_real=4, rank=1))],
              tmp_path, timeout_s=timeout)
    assert time.perf_counter() - t0 < timeout


def test_backend_choice(monkeypatch):
    """NCCL where every rank has a card, gloo on the CPU and for ranks
    sharing a card (so NCCL never meets more ranks than cards); no card,
    no CUDA run."""
    assert choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        choose_backend("mps", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        choose_backend("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend("cuda", 1) == "nccl"
    assert choose_backend("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend("cuda", 4) == "nccl"
    assert choose_backend("cuda", 5) == "gloo"


def test_group_needs_an_initialised_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        sharding.ShardGroup(4)


def test_walkers_refuse_a_group_without_a_frozen_corrector():
    """Only the frozen bordered corrector shards (the JAX package's
    ``continuation.py:297-304``, ``branches.py:129-135``)."""
    _, pcfg = configs(n_neurons=256, n_real=4)
    noise = torch.zeros(4, 256, dtype=torch.float64)
    exact = pt.NewtonConfig(fd_mode="exact")
    group = object()     # refused before it is used
    with pytest.raises(ValueError, match="frozen corrector"):
        make_arclength_step(pcfg, noise, 0.0, "beta", exact, group=group)
    with pytest.raises(ValueError, match="frozen corrector"):
        continue_branch(pcfg, noise, INITIAL_GUESS, 13.0589, ncfg=exact,
                        group=group)
    with pytest.raises(ValueError, match="frozen corrector"):
        enumerate_branches(pcfg, noise, INITIAL_GUESS, 13.0589, ncfg=exact,
                           group=group)


@pytest.mark.parametrize("argv, ignored", [
    (["--track-fold"], True), (["--track-boundary"], True),
    (["--arclength"], True), (["--enumerate-branches", "--fd-mode",
                               "exact"], True),
    (["--arclength", "--fd-mode", "frozen"], False),
    (["--enumerate-branches", "--fd-mode", "frozen-fwd"], False),
    (["--staged"], False), ([], False)])
def test_cli_says_where_shard_is_ignored(argv, ignored):
    """The JAX CLI's rule (``cli/driver.py:400-411``)."""
    args = driver.build_parser().parse_args(argv + ["--shard", "2"])
    assert driver.shard_ignored(args) == ignored


def test_cli_shard_2_equals_unsharded(tmp_path, capfd):
    """``--cpu --shard 2`` for two sweep steps equals ``--cpu`` at f64
    1e-12 (the checkpoints rank 0 wrote), with the backend printed."""
    argv = ["--cpu", "--neurons", "512", "--realisations", "4",
            "--dtype", "float64", "--tol", "1e-8", "--fd-eps", "1e-7",
            "--steps", "2", "--sigma", "0.1", "--quiet"]
    assert driver.main(argv + ["--checkpoint", str(tmp_path / "u")]) == 0
    capfd.readouterr()
    assert driver.main(argv + ["--checkpoint", str(tmp_path / "s"),
                               "--shard", "2"]) == 0
    err = capfd.readouterr().err
    assert "2 rank(s) on gloo (cpu)" in err
    from armadillocudalinearinterpolation_torch.utils.checkpoint import (
        ContinuationCheckpoint)
    u = ContinuationCheckpoint(str(tmp_path / "u")).load_all()
    s = ContinuationCheckpoint(str(tmp_path / "s")).load_all()
    assert [x.index for x in s] == [x.index for x in u] == [0, 1]
    for a, b in zip(s, u):
        assert a.converged and b.converged
        np.testing.assert_allclose(a.solution, b.solution, rtol=0,
                                   atol=1e-12)
