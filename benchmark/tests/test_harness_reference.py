"""The reference map agrees with the port's plain CPU path; the
operation counts and the roofline arithmetic repeat exactly."""

import warnings
from types import SimpleNamespace

import pytest
import torch

from benchmark import yardstick
from benchmark.reference import edmap

MODEL = dict(n_spikes=3, vth=1.0, drive=0.9, a1=11.0, a2=7.0, b1=5.0,
             b2=3.5, half_width=3.0, t_horizon=5.0, root_tol=1e-12,
             counter_max=50)


@pytest.mark.parametrize("n", [256, 512])
def test_reference_map_agrees_with_the_port(n):
    import armadillocudalinearinterpolation_torch as pt
    R = 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = pt.ModelConfig(n_neurons=n, n_real=R, dtype="float64",
                             root_tol=1e-12)
    params = pt.MapParams.create(13.0589, 0.1, dtype="float64")
    gen = torch.Generator().manual_seed(3)
    rates = 13.0589 + 0.1 * torch.randn(R, n, generator=gen,
                                        dtype=torch.float64)
    Z = torch.tensor([[0.3310, 0.6914, 1.3557], [0.3262, 0.7205, 1.3703]],
                     dtype=torch.float64)
    port = pt.event_driven_map(cfg, params, rates, Z, evolve_backend="torch")
    ref = edmap.residual(edmap.Model.of(dict(MODEL, n_neurons=n)), Z,
                         torch.full((2,), 13.0589, dtype=torch.float64),
                         rates[None].expand(2, R, n))
    # (at N=64 no lane of the lift fires: both maps are NaN everywhere)
    assert not ref.isnan().any()
    assert (port - ref).abs().max() <= 1e-12


def test_operation_counts():
    assert (yardstick.ADVANCE_OPS, yardstick.DECISION_OPS,
            yardstick.ARGMIN_OPS, yardstick.TANGENT_OPS) == (20, 13, 1, 19)
    assert yardstick.K1_OPS == 34 and yardstick.K2_OPS == 20
    assert [yardstick.k2t_ops(d) for d in (1, 3, 4)] == [39, 77, 96]


def test_launch_work_repeats_exactly():
    # K1 on config 4's stage-1 stencil: 7 points of 64 rows x 4096 lanes
    shapes = [[], [7, 4096], [7, 4096], [64, 4096], [7, 3], [], [], [], []]
    ops, n_bytes = yardstick.launch_work("atorch::evolve", shapes, 64, 3,
                                         3395.421875, "float32")
    assert ops == 448 * 4096 * 3395.421875 * 34
    assert n_bytes == (14 + 64) * 4096 * 4 + 448 * (3 * 2 * 8 + 5)
    # K2T at D=3 on 64 rows of f64
    shapes = [[], [64, 4224], [64], [1, 4096], [1, 4096], [64, 4096], [1, 3],
              [3, 1, 4096], [3, 1, 4096], [], [], [], []]
    ops, _ = yardstick.launch_work("atorch::replay_tangent", shapes, 64, 3,
                                   100.0, "float64")
    assert ops == 64 * 4096 * 100.0 * 77
    assert yardstick.least_seconds(67e12, 1.0, "float32") == (1.0,
                                                              "operations")
    assert yardstick.least_seconds(1.0, 3.35e12, "float64") == (1.0, "bytes")


def test_roofline_share_of_a_trace():
    calls = [[[], [1, 512], [1, 512], [8, 512], [1, 3], [], [], [], []]] * 2
    trace = SimpleNamespace(
        op_calls=lambda name: calls if name == "atorch::evolve" else [],
        kernel_seconds=lambda match: [("evolve_kernel<float, false>", 1e-3),
                                      ("evolve_kernel<float, false>", 3e-3)])
    share = yardstick.roofline_share(trace, "atorch::evolve",
                                     lambda n: True, 8, 3, 400.0, "float32")
    least = 2 * 8 * 512 * 400.0 * 34 / 67e12
    assert share == pytest.approx(100.0 * least / 4e-3, rel=1e-15)
    # a count that does not pair gives no share
    trace.op_calls = lambda name: calls[:1]
    assert yardstick.roofline_share(trace, "atorch::evolve", lambda n: True,
                                    8, 3, 400.0, "float32") is None


def test_stream_seeds_gaps_and_union():
    assert yardstick.stream_seed(1, "pool", 3) == yardstick.stream_seed(
        1, "pool", 3)
    assert yardstick.stream_seed(1, "pool", 3) != yardstick.stream_seed(
        2, "pool", 3)
    assert 0 <= yardstick.stream_seed(2 ** 40, "x") < 2 ** 63
    assert yardstick.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert yardstick.union_seconds([(0, 2e6), (1e6, 3e6)]) == 3.0
