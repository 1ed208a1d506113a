"""K1's profiler counters (``utils/profiling.py``) on the card: under a
profiler a launch of the evolve kernel adds its rows, the sum of its
``n_events`` and, windowed, the sum of its rows' fallback counts, the
kernel's own outputs; its results are those of an untraced launch bit for
bit; with no profiler the counters stay where they are.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k1_counters_cuda.py -m cuda
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import armadillocudalinearinterpolation_torch as pt
from armadillocudalinearinterpolation_torch.model import evolve_cuda
from armadillocudalinearinterpolation_torch.utils.profiling import (
    K1_COUNTERS)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def spread_inputs(card, dtype, window):
    """Spikes spread far beyond one 128-lane window, so that windowed
    events fall back to every lane (the forced-fallback case of
    ``test_torch_evolve_window_cuda.py``), at N=512 and R=4."""
    cfg = pt.ModelConfig(n_neurons=512, n_real=4, dtype=dtype,
                         evolve_window=window)
    params = pt.MapParams.create(13.0589, 0.0, dtype=dtype, device=card)
    U = torch.tensor([[0.3262, 0.0, 0.7194, 1.3690]], dtype=cfg.torch_dtype,
                     device=card)
    v0, s0 = (x.contiguous() for x in pt.lift(cfg, params, U))
    g = torch.Generator(card).manual_seed(7)
    beta = (13.0589 + 0.1 * torch.randn(4, 512, generator=g, device=card,
                                        dtype=cfg.torch_dtype)).contiguous()
    ii = torch.tensor([[420, 256, 60]], dtype=torch.int32, device=card)
    return cfg, v0, s0, beta, ii


def moved(before, after):
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("asked", [False, True],
                         ids=["fallbacks_not_asked", "fallbacks_asked"])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_counters_are_the_launch_outputs(card, dtype, window, asked):
    cfg, v0, s0, beta, ii = spread_inputs(card, dtype, window)
    rows = 4

    def launch():
        fb = (torch.full((rows,), -1, dtype=torch.int32, device=card)
              if asked else None)
        res = evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii,
                                               fallbacks=fb)
        return res, fb

    # the fallback counts by hand: an untraced launch that asks for them
    fb_hand = torch.zeros(rows, dtype=torch.int32, device=card)
    evolve_cuda.evolve_ensemble_cuda(cfg, v0, s0, beta, ii,
                                     fallbacks=fb_hand)
    plain, fb_plain = launch()
    torch.cuda.synchronize()
    before = K1_COUNTERS.snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced, fb_traced = launch()
        torch.cuda.synchronize()
    counted = moved(before, K1_COUNTERS.snapshot())

    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    if asked:
        assert torch.equal(fb_plain, fb_traced)
        assert torch.equal(fb_traced, fb_hand)
    events = int(traced.n_events.sum())
    fallback = int(fb_hand.sum())
    want = {"launches": 1, "rows": rows, "events": events,
            "windowed_rows": rows if window else 0,
            "windowed_events": events if window else 0,
            "fallback_events": fallback if window else 0}
    assert counted == want
    if window:
        assert 0 < fallback <= events

    # no profiler: the counters do not move
    before = K1_COUNTERS.snapshot()
    launch()
    torch.cuda.synchronize()
    assert K1_COUNTERS.snapshot() == before
