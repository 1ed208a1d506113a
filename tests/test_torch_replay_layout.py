"""The replay kernel's (K2's) launch layout, on the CPU: the block size
that ``model/replay_cuda.py::replay_layout`` picks for one CTA a row, and
the shared memory of a row (``model/evolve_cuda.py::row_shared_bytes`` /
``row_fits_shared``) at its limits.  The kernel itself is held to the plain
replay at every block size by the card tests of
``tests/test_torch_replay_cuda.py``."""

import pytest
import torch

from armadillocudalinearinterpolation_torch.model import (evolve_cuda,
                                                          replay_cuda)
from armadillocudalinearinterpolation_torch.model.replay_cuda import (
    MAX_THREADS, SHARED_PER_SM, SHARED_RESERVED_PER_CTA, THREADS_PER_SM,
    replay_layout)

SMS = 132                       # an H100 SXM
F64 = torch.float64
ROWS = (1, 64, 132, 256, 3000)
WIDTHS = (40, 4095, 4096, 8448, 16896)


def cta_bytes(N, M):
    """One CTA's dynamic shared memory, the row in device memory where it
    does not fit."""
    if evolve_cuda.row_fits_shared(N, M, F64, "replay"):
        return evolve_cuda.row_shared_bytes(N, M, F64, "replay")
    return (2 * M + 2) * 8 + (3 * M + 2) * 4


@pytest.mark.parametrize("N, rows, threads", [
    (4096, 64, 512),       # config 4's replay: one row an SM
    (4096, 132, 512),
    (4096, 256, 512),      # the forward stencil: two rows an SM
    (4096, 396, 512),      # shared memory holds two rows an SM
    (4096, 3000, 512),
    (4096, 1, 512),
    (4095, 64, 512),
    (2048, 396, 320),      # three rows an SM
    (2048, 1024, 320),     # shared memory holds three
    (40, 1, 96),           # the event warp and the lanes' warps
    (40, 3000, 64),        # the floor: one sweep warp
    (8297, 396, 512),      # the widest row in shared memory: one an SM
    (8298, 396, 320),      # one lane more: in device memory, three an SM
    (8448, 2, 512),        # rows in device memory
    (8448, 64, 512),
    (8448, 132, 512),
    (8448, 3000, 64),
    (16896, 1, 512),
])
def test_replay_layout_cases(N, rows, threads):
    assert replay_layout(N, 3, rows, SMS) == threads


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("N", WIDTHS)
def test_replay_layout_limits(N, rows):
    """Threads: a multiple of 32 from 64 to K2's 512, no more sweep
    threads than lanes rounded up to a warp, and within the register file
    (1024 threads of K2) beside the other CTAs an SM holds for one
    wave."""
    M = 3
    threads = replay_layout(N, M, rows, SMS)
    assert threads % 32 == 0 and 64 <= threads <= MAX_THREADS
    assert threads - 32 <= max(32, -(-N // 32) * 32)
    per_sm = -(-rows // SMS)
    held = min(per_sm, SHARED_PER_SM // (cta_bytes(N, M)
                                         + SHARED_RESERVED_PER_CTA))
    # K2's 64 registers a thread: 1024 threads an SM in all
    assert threads * held <= THREADS_PER_SM or threads == 64


def test_replay_layout_follows_the_card():
    """396 rows of 2048 lanes take three rows an SM on 132 SMs but two on
    264; a smaller opt-in limit sends a config-4 row to device memory,
    which leaves the SM's shared memory to a third CTA."""
    assert replay_layout(2048, 3, 396, 264) == 512
    assert replay_layout(2048, 3, 396, SMS) == 320
    assert replay_layout(4096, 3, 396, SMS, 101_376) == 320


@pytest.mark.parametrize("shared_per_sm, threads", [
    (SHARED_PER_SM, 320),      # an H100 SM holds three rows of 2048 lanes
    (167_936, 512),            # an SM of 164 KB holds two: more waves
    (466_944, 320),            # more shared memory: still three a wave
])
def test_replay_layout_counts_the_cards_shared_memory(shared_per_sm,
                                                      threads):
    """396 rows of 2048 lanes on 132 SMs: the rows an SM holds at once,
    and so the threads each gets, follow the shared memory of the card's
    SM."""
    assert replay_layout(2048, 3, 396, SMS, 232_448, shared_per_sm) \
        == threads


@pytest.mark.parametrize("M, n_max", [(1, 8299), (3, 8297), (8, 8292)])
def test_replay_row_fits_shared_at_its_limits(M, n_max):
    """The largest N whose row fits the 232,448-byte opt-in: 3N lanes of
    v, s and beta, the N/2 + 1 kick table, the bookkeeping of M
    trajectories and the two-slot mailbox."""
    assert evolve_cuda.row_fits_shared(n_max, M, F64, "replay")
    assert not evolve_cuda.row_fits_shared(n_max + 1, M, F64, "replay")
    assert evolve_cuda.row_shared_bytes(n_max + 1, M, F64, "replay") > \
        evolve_cuda.SHARED_OPTIN_BYTES


def test_replay_row_shared_bytes_counts_every_array():
    for N, M in ((4096, 3), (4095, 3), (40, 5), (8448, 3)):
        assert evolve_cuda.row_shared_bytes(N, M, F64, "replay") \
            == (3 * N + N // 2 + 1 + 2 * M + 2) * 8 + (3 * M + 2) * 4
    # config 4's row: 114,804 bytes
    assert evolve_cuda.row_shared_bytes(4096, 3, F64, "replay") == 114_804


def test_replay_wrapper_has_no_layout_option():
    """The block size is replay_layout's, always: the wrapper takes no
    threads= argument."""
    import inspect
    params = inspect.signature(replay_cuda.replay_events_cuda).parameters
    assert "threads" not in params and "cluster" not in params


# ------------------------------------------------------------- K2T layout

def tangent_cta_bytes(N, M, D, C, in_shared=True):
    """One K2T CTA's shared memory, array by array (csrc/replay.cu,
    ``replay_body`` with kTangent): its ceil(N / C) lanes of v, s, beta,
    the rates' tangent base and D pairs (dv, ds), the kick table; the
    last and crossed times and their D tangents of each trajectory; the
    two mailbox slots of dt and D d(dt); t's D tangents and the point's D
    dp; last_ind, crossed_ind, crossed and the two flags."""
    lanes = -(-N // C)
    doubles = ((4 + 2 * D) * lanes + N // 2 + 1 if in_shared else 0) \
        + 2 * M + 2 * D * M + 2 * (1 + D) + D + D
    return doubles * 8 + (3 * M + 2) * 4


@pytest.mark.parametrize("N, D, rows, layout", [
    (4096, 4, 64, (2, 512, True)),     # config 4: 128 CTAs, one wave
    (4096, 3, 64, (2, 512, True)),
    (4096, 1, 64, (2, 512, True)),     # fits one CTA: a pair, one wave
    (4096, 1, 132, (1, 512, True)),    # pairs would take two waves
    (4096, 4, 256, (2, 512, True)),    # shared memory holds one CTA an SM
    (2048, 4, 64, (2, 512, True)),     # a pair: 1024 lanes a CTA
    (2048, 4, 66, (2, 512, True)),     # 132 CTAs, still one wave
    (2048, 4, 67, (1, 512, True)),
    (1024, 4, 64, (1, 512, True)),     # 512 lanes a CTA of a pair: one CTA
    (512, 4, 4, (1, 512, True)),       # the walkers' rows: one CTA each
    (512, 4, 256, (1, 256, True)),     # two rows an SM
    (8448, 4, 2, (8, 512, True)),      # 1056 lanes a CTA
    (16896, 4, 2, (1, 512, False)),    # no cluster of 8 holds it
])
def test_tangent_layout_cases(N, D, rows, layout):
    assert replay_layout(N, 3, rows, SMS, kind="tangent", D=D) == layout


@pytest.mark.parametrize("D", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("C", replay_cuda.CLUSTER_SIZES)
def test_tangent_layout_at_its_shared_memory_limits(C, D):
    """The widest row that cluster C holds in shared memory (D directions,
    3 trajectories): at that N the layout takes C (or a smaller one), one
    lane more takes the next size or device memory; the byte count is the
    kernel's array by array.  At one row an SM, so that no pair is taken
    for a row that fits one CTA (``test_tangent_layout_cases``)."""
    M, optin = 3, replay_cuda.SHARED_OPTIN_BYTES
    n_max = max(N for N in range(C, 40_000 * C, C)
                if tangent_cta_bytes(N, M, D, C) <= optin)
    for N in (n_max - 1, n_max, n_max + 1):
        for c in replay_cuda.CLUSTER_SIZES:
            for in_shared in (True, False):
                assert replay_cuda.tangent_shared_bytes(
                    N, M, D, c, in_shared) == \
                    tangent_cta_bytes(N, M, D, c, in_shared)
    got = replay_layout(n_max, M, SMS, SMS, kind="tangent", D=D)
    assert got.in_shared and got.cluster <= C
    assert tangent_cta_bytes(n_max, M, D, got.cluster) <= optin
    nxt = replay_layout(n_max + C, M, SMS, SMS, kind="tangent", D=D)
    assert nxt.cluster > C or not nxt.in_shared


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("N", WIDTHS)
@pytest.mark.parametrize("D", [1, 3, 4])
def test_tangent_layout_limits(N, rows, D):
    """K2T's CTAs: whole warps from 64 to 512 threads, no more sweep
    threads than a CTA's lanes rounded up to a warp, and within 512
    threads an SM (K2T's registers) beside the CTAs an SM holds for one
    wave; the smallest cluster whose CTAs fit, else device memory, or a
    pair in place of one CTA where each keeps 1024 lanes and the pairs
    make one wave."""
    M = 3
    C, threads, in_shared = replay_layout(N, M, rows, SMS, kind="tangent",
                                          D=D)
    assert threads % 32 == 0 and 64 <= threads <= MAX_THREADS
    assert threads - 32 <= max(32, -(-(-(-N // C)) // 32) * 32)
    pair = (tangent_cta_bytes(N, M, D, 1) <= 232_448 and 2 * rows <= SMS
            and N // 2 >= replay_cuda.TANGENT_PAIR_MIN_LANES)
    smaller = [c for c in replay_cuda.CLUSTER_SIZES if c < C]
    if pair:
        assert C == 2 and in_shared
    else:
        assert all(tangent_cta_bytes(N, M, D, c) > 232_448 for c in smaller)
    if in_shared:
        assert tangent_cta_bytes(N, M, D, C) <= 232_448
    else:
        assert C == 1 and tangent_cta_bytes(N, M, D, 8) > 232_448
    held = min(-(-(rows * C) // SMS), SHARED_PER_SM // (
        tangent_cta_bytes(N, M, D, C, in_shared) + SHARED_RESERVED_PER_CTA))
    assert threads * max(1, held) <= replay_cuda.TANGENT_THREADS_PER_SM \
        or threads == 64


def test_tangent_layout_follows_the_card():
    """A card whose blocks opt in to 99 KB splits config 4's row over 8
    CTAs (4 take 114 KB each), three of them an SM; one of twice the SMs
    gives 256 rows of N=4096 one SM each."""
    assert replay_layout(4096, 3, 64, SMS, 101_376, kind="tangent",
                         D=4) == (8, 160, True)
    assert replay_layout(4096, 3, 256, 2 * SMS, kind="tangent",
                         D=4).threads == 512


def test_tangent_wrapper_has_no_layout_option():
    """The cluster and block size are replay_layout's, always."""
    import inspect
    params = inspect.signature(
        replay_cuda.replay_events_tangent_cuda).parameters
    assert not {"threads", "cluster", "layout"} & set(params)
