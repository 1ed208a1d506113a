"""Linear-stability analysis of fixed points.

Eigenvalues of the Jacobian, counted unstable under one of three criteria:

  * ``flow``          — Re(lambda) > 0
  * ``map``           — |lambda| > 1
  * ``equation_free`` — the map is ``M(U) = U + F(U)``, so add the identity
    first, then the map test.

The tiny ``n_spikes x n_spikes`` eigenproblem runs in float64 numpy on the
host, as the reference runs Armadillo's ``eig_gen`` on the CPU beside a GPU
map.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch

from ..solvers.newton import fd_jacobian


class ProblemType(enum.Enum):
    """Stability criterion selector."""

    FLOW = "flow"
    MAP = "map"
    EQUATION_FREE = "equation_free"


def eigvals(jacobian) -> np.ndarray:
    """Eigenvalues of a small dense general matrix, complex128 on the host.
    A non-finite matrix (a failed solve) gives a NaN spectrum."""
    if isinstance(jacobian, torch.Tensor):
        jacobian = jacobian.detach().cpu().numpy()
    j64 = np.asarray(jacobian, np.float64)
    if not np.isfinite(j64).all():
        return np.full((j64.shape[0],), np.nan + 1j * np.nan, np.complex128)
    return np.linalg.eigvals(j64).astype(np.complex128)


def compute_eigenvalues(
    F: Callable[[torch.Tensor], torch.Tensor],
    u: torch.Tensor,
    problem_type: ProblemType = ProblemType.EQUATION_FREE,
    *,
    epsilon: float = 1e-2,
    jacobian_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    jacobian: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Spectrum of the linearisation at ``u``: from ``jacobian`` (e.g. the
    solver's export), else ``jacobian_fn``, else forward differences at
    ``epsilon``."""
    if jacobian is None:
        if jacobian_fn is not None:
            jacobian = jacobian_fn(u)
        else:
            jacobian = fd_jacobian(F, u, F(u), epsilon)
    if problem_type is ProblemType.EQUATION_FREE:
        jacobian = jacobian + torch.eye(jacobian.shape[0],
                                        dtype=jacobian.dtype,
                                        device=jacobian.device)
    return eigvals(jacobian)


def count_unstable(eigenvalues, problem_type: ProblemType) -> int:
    """Unstable-eigenvalue count under the given criterion."""
    ev = np.asarray(eigenvalues)
    if problem_type is ProblemType.FLOW:
        return int(np.sum(np.real(ev) > 0.0))
    return int(np.sum(np.abs(ev) > 1.0))


def num_unstable_eigenvalues(
    F: Callable[[torch.Tensor], torch.Tensor],
    u: torch.Tensor,
    problem_type: ProblemType = ProblemType.EQUATION_FREE,
    **kwargs,
) -> int:
    """Count unstable eigenvalues at ``u``."""
    ev = compute_eigenvalues(F, u, problem_type, **kwargs)
    return count_unstable(ev, problem_type)
