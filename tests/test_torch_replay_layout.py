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
