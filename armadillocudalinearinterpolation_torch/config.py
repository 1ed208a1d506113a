"""Configuration for the PyTorch port of the event-driven-map framework.

Same fields, defaults and validation as the JAX package's ``config.py``,
minus the knobs that only served the TPU (the per-row evolve window, whose
per-row anchoring the CUDA kernel has by construction, the df64 replay
modes and the warm-started evolve).  ``ModelConfig`` and
``NewtonConfig`` are frozen dataclasses; ``MapParams`` holds the
continuation parameters ``(beta, sigma)`` as 0-dim tensors.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model and discretisation constants.

    Attributes:
      n_neurons: neurons per realisation (reference ``mNoThreads``).
      n_real: Monte-Carlo realisations (reference ``noReal``).
      n_spikes: spike trajectories tracked (reference ``noSpikes`` = 3).
      vth / vr: firing threshold and reset voltage (``vr`` must be 0).
      a1, a2, b1, b2: Mexican-hat coupling amplitudes and decay rates.
      drive: constant external drive (reference ``I``).
      half_width: ring half-domain ``L``; x in [-L, L).
      t_horizon: restriction time horizon ``T``.
      root_tol: event-time Newton tolerance.
      counter_max: event-time Newton iteration cap.
      max_events: event-log bound of the schedule replay: the firing-order
        log of the f32 discovery pass holds ``max_events`` rounded up to a
        multiple of 128 events per row, and a row with more events is
        rejected by the replay (:mod:`.model.replay`).
      evolve_window: lanes of the windowed event-time root-find (0 = all
        lanes), validated as in the JAX package.  The evolve kernel and its
        plain version (``model/evolve_batched.py``) run the root-find on
        that many lanes around each row's wave packet and certify every
        event, so the results equal those of every lane.
      dtype: ``"float32"`` or ``"float64"``.
    """

    n_neurons: int = 1024
    n_real: int = 1000
    n_spikes: int = 3
    vth: float = 1.0
    vr: float = 0.0
    a1: float = 11.0
    a2: float = 7.0
    b1: float = 5.0
    b2: float = 3.5
    drive: float = 0.9
    half_width: float = 3.0
    t_horizon: float = 5.0
    root_tol: float = 1e-6
    counter_max: int = 50
    max_events: int = 4096
    evolve_window: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        if self.n_neurons < 1 or self.n_real < 1 or self.n_spikes < 1:
            raise ValueError("n_neurons, n_real, n_spikes must be positive")
        if self.max_events < 1:
            raise ValueError("max_events must be positive (it sizes the "
                             "event log and the replay scan)")
        if self.vr != 0.0:
            raise ValueError("vr != 0 is not supported: the reset is "
                             "multiplicative (v=0), as in the reference")
        if self.evolve_window and (self.evolve_window % 128
                                   or not 0 < self.evolve_window < self.n_neurons):
            raise ValueError("evolve_window must be a multiple of 128 in "
                             f"(0, n_neurons); got {self.evolve_window}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be 'float32' or 'float64'; got "
                             f"{self.dtype!r}")
        if self.n_neurons < 256:
            warnings.warn(
                f"n_neurons={self.n_neurons} is below the model's physical "
                "resolution floor (~256 at the default parameters): the "
                "lifted state may fire no neurons, rejecting every "
                "realisation (NaN mean).", stacklevel=2)

    @property
    def dx(self) -> float:
        return 2.0 * self.half_width / self.n_neurons

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def grid(self, device=None) -> torch.Tensor:
        """Ring coordinates x_i = -L + i*dx, ascending."""
        return (-self.half_width
                + self.dx * torch.arange(self.n_neurons,
                                         dtype=self.torch_dtype,
                                         device=device))

    def with_(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MapParams:
    """Continuation parameters: mean synaptic rate ``beta`` (the parameter
    the reference sweeps) and heterogeneity std-dev ``sigma``, as 0-dim
    tensors of the working dtype."""

    beta: torch.Tensor
    sigma: torch.Tensor

    @staticmethod
    def create(beta: float, sigma: float = 0.0, dtype: str = "float32",
               device: Optional[torch.device] = None) -> "MapParams":
        td = _DTYPES[dtype]
        return MapParams(beta=torch.tensor(beta, dtype=td, device=device),
                         sigma=torch.tensor(sigma, dtype=td, device=device))


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton solver parameters (reference ``NewtonSolver::ParameterList``,
    defaults from ``Driver.cu``)."""

    tolerance: float = 1e-4
    max_iterations: int = 10
    fd_epsilon: float = 1e-2
    damping: float = 1.0
    print_output: bool = False
    # "forward" FD (reference), "central" FD, or "exact" (the residual's
    # own exact Jacobian, F.value_and_jacobian, or torch.func.jacfwd of a
    # differentiable callable: solvers/newton.py::exact_jacobian); "frozen"
    # and "frozen-fwd" are the central and forward frozen-schedule stencils
    # that only the staged solver's accurate stage takes
    # (solvers/staged.py::newton_solve_frozen).
    fd_mode: str = "forward"
    # Stop once the residual norm exceeds divergence_factor * initial norm.
    divergence_factor: float = float("inf")
