"""Convergence criteria: ``(residual_norm) -> bool`` closures, so solvers
stay criterion-agnostic as the reference's solver is via its
``ConvergenceCriterion`` member."""

from __future__ import annotations

from typing import Callable

Criterion = Callable[[float], bool]


def residual_norm_criterion(tolerance: float) -> Criterion:
    """Absolute residual-norm test ``||r|| <= tol`` (the reference's)."""
    def test(residual_norm: float) -> bool:
        return float(residual_norm) <= tolerance
    return test


def relative_criterion(tolerance: float, initial_norm: float) -> Criterion:
    """Relative test ``||r|| <= tol * ||r0||``."""
    def test(residual_norm: float) -> bool:
        return float(residual_norm) <= tolerance * float(initial_norm)
    return test
