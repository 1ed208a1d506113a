"""The Newton direction solve: an ``n_spikes``-sized dense system."""

from __future__ import annotations

import torch

from ..utils.profiling import spanned


@spanned("solvers.linear_solve")
def solve_dense(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for ``b`` of shape ``(n,)`` or ``(n, k)``.

    A singular matrix yields NaN, as in the JAX package: a failed solve
    shows in the residual instead of raising mid-iteration.
    """
    n = A.shape[0]
    if A.shape != (n, n):
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    x, info = torch.linalg.solve_ex(A.to(b.dtype), b)
    if int(info) != 0:
        return torch.full_like(x, float("nan"))
    return x
