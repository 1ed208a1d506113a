"""PyTorch and CUDA port of the equation-free event-driven-map framework.

The JAX package ``armadillocudalinearinterpolation_tpu`` is the reference;
this package computes the same map on torch tensors, with the event-driven
evolve as a hand-written CUDA kernel for Hopper (``csrc/evolve.cu``, built
with ``nvcc`` at first use) beside its plain PyTorch version.  The map
``F(Z)`` (lift -> evolve -> restrict -> masked mean -> residual), damped
Newton with finite-difference Jacobians, and the eigenvalue stability count
are the first slice ported; batched 2-D bilinear interpolation
(``ops/interp_cuda.py``: f32 gather and bin-window kernels, native fp64,
``csrc/interp2d.cu``) is the second; the 1-D interpolation family
(``ops/interp1d_cuda.py``: uniform-grid, sorted-batch and non-uniform
lerp, ``csrc/interp1d.cu``) is the third; the staged Newton to
``|F| <= 1e-8`` (the evolve kernel's firing-order log, the fp64 schedule
replay kernel ``csrc/replay.cu``, the frozen-schedule map and
``newton_solve_staged``) is the fourth; the ``Driver.cu`` program's entry
point (``cli/driver.py``: the continuation sweep with stability,
checkpoint/resume in the JAX package's format and stage dumps, ``utils/``)
is the fifth; exact Jacobians (the tangent replay kernel K2T in
``csrc/replay.cu``, ``F.value_and_jacobian``, ``fd_mode="exact"``) and the
walkers that use them (``analysis/``: pseudo-arclength continuation, fold
tracking, branch enumeration, existence-boundary tracking, and their CLI
modes) are the sixth.  The map is forward-differentiable by PyTorch's own
AD (``torch.func.jvp``, ``torch.func.jacfwd``, ``jacfwd_cols``,
``torch.autograd.forward_ad``): K1, K2 and K2T are ``torch.library`` ops
and the evolve an ``autograd.Function`` (``model/autodiff.py``).  This
package never imports JAX.
"""

from .config import ModelConfig, MapParams, NewtonConfig
from .model.coupling import coupling_kernel, coupling_row, mexican_hat
from .model.lift import lift, initial_spike_indices
from .model.events import event_time, event_time_jvp
from .model.evolve import EvolveResult, evolve_ensemble
from .model.evolve_batched import evolve_ensemble_batched
from .model.evolve_cuda import evolve_ensemble_cuda
from .model.replay import (compute_schedule, replay_events,
                           replay_events_tangent, evolve_ensemble_replay)
from .model.replay_cuda import (replay_events_cuda,
                                replay_events_tangent_cuda)
from .model.restrict import restrict_positions, masked_ensemble_mean
from .model.emap import (
    z_to_u,
    u_to_z,
    sample_beta,
    sample_noise,
    beta_from_noise,
    event_driven_map,
    make_residual_fn,
    ResidualFn,
    map_jvp,
    differentiable_backend,
    MapDiagnostics,
    compute_discrete_outcome,
    frozen_schedule_map,
    frozen_schedule_map_batched,
)
from .solvers.criterion import residual_norm_criterion, relative_criterion
from .solvers.newton import (newton_solve, fd_jacobian, central_fd_jacobian,
                             exact_jacobian, jacfwd_cols,
                             print_iteration_table,
                             NewtonResult, frozen_jacobian_polish,
                             JacobianUnavailable)
from .solvers.staged import newton_solve_frozen, newton_solve_staged
from .ops.interp_cuda import bilinear_batched, bilinear_batched_f64
from .ops.interp1d_cuda import lerp1d, lerp1d_binned, make_interp1d
from .utils.checkpoint import ContinuationCheckpoint, ContinuationStep
from .utils.debug import compare_dumps, dump_map_stages
from .analysis.stability import (
    ProblemType,
    compute_eigenvalues,
    count_unstable,
    num_unstable_eigenvalues,
)
from .analysis.continuation import (
    ArcStep,
    continue_branch,
    arclength_step,
    make_extended_residual,
    make_arclength_step_frozen,
)
from .analysis.fold import FoldPoint, solve_fold, track_fold
from .analysis.branches import Branch, enumerate_branches
from .analysis.boundary import BoundaryPoint, track_existence_boundary

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "MapParams",
    "NewtonConfig",
    "coupling_kernel",
    "coupling_row",
    "mexican_hat",
    "lift",
    "initial_spike_indices",
    "event_time",
    "event_time_jvp",
    "EvolveResult",
    "evolve_ensemble",
    "evolve_ensemble_batched",
    "evolve_ensemble_cuda",
    "compute_schedule",
    "replay_events",
    "replay_events_tangent",
    "evolve_ensemble_replay",
    "replay_events_cuda",
    "replay_events_tangent_cuda",
    "restrict_positions",
    "masked_ensemble_mean",
    "z_to_u",
    "u_to_z",
    "sample_beta",
    "sample_noise",
    "beta_from_noise",
    "event_driven_map",
    "make_residual_fn",
    "ResidualFn",
    "map_jvp",
    "differentiable_backend",
    "MapDiagnostics",
    "compute_discrete_outcome",
    "frozen_schedule_map",
    "frozen_schedule_map_batched",
    "residual_norm_criterion",
    "relative_criterion",
    "newton_solve",
    "fd_jacobian",
    "central_fd_jacobian",
    "exact_jacobian",
    "jacfwd_cols",
    "JacobianUnavailable",
    "print_iteration_table",
    "NewtonResult",
    "frozen_jacobian_polish",
    "newton_solve_frozen",
    "newton_solve_staged",
    "ProblemType",
    "compute_eigenvalues",
    "count_unstable",
    "num_unstable_eigenvalues",
    "ArcStep",
    "continue_branch",
    "arclength_step",
    "make_extended_residual",
    "make_arclength_step_frozen",
    "FoldPoint",
    "solve_fold",
    "track_fold",
    "Branch",
    "enumerate_branches",
    "BoundaryPoint",
    "track_existence_boundary",
    "bilinear_batched",
    "bilinear_batched_f64",
    "lerp1d",
    "lerp1d_binned",
    "make_interp1d",
    "ContinuationCheckpoint",
    "ContinuationStep",
    "dump_map_stages",
    "compare_dumps",
]
