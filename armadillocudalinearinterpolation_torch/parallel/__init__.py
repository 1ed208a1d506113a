"""Parallel layer: the Monte-Carlo ensemble sharded over
``torch.distributed`` ranks (the JAX package's ``parallel/``)."""

from .sharding import (
    RankPool,
    ShardGroup,
    choose_backend,
    event_driven_map_sharded,
    make_sharded_residual_fn,
    run_ranks,
    sharded_newton_solve,
)

__all__ = [
    "RankPool",
    "ShardGroup",
    "choose_backend",
    "event_driven_map_sharded",
    "make_sharded_residual_fn",
    "run_ranks",
    "sharded_newton_solve",
]
