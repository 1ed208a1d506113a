"""Carry state across from the JAX package, without importing JAX.

The system has no weights; the state that must match across the packages
is the configuration, the continuation parameters ``(beta, sigma)``, the
``(R, N)`` heterogeneity draw and the map state ``Z``.  Callers pass plain
dicts (``dataclasses.asdict`` of a JAX config) and numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Union

import numpy as np
import torch

from .config import MapParams, ModelConfig, NewtonConfig

# JAX ModelConfig knobs the port leaves out, with their defaults there
_LEFT_OUT = {
    "evolve_window_per_row": False,
    "replay_exp_mode": "hoisted",
    "replay_loop": "while",
    "replay_jvp": "df64",
    "evolve_warm_start": False,
    "evolve_warm_margin": 0.05,
}


def config_from_fields(d: Mapping[str, Any]
                       ) -> Union[ModelConfig, NewtonConfig]:
    """A port config from the fields of a JAX ``ModelConfig`` or
    ``NewtonConfig``.

    A knob the port leaves out is dropped when it holds the JAX default and
    raises otherwise: the port would compute something else than asked.
    Unknown fields raise.
    """
    d = dict(d)
    for name, default in _LEFT_OUT.items():
        if name in d and (value := d.pop(name)) != default:
            raise ValueError(f"{name}={value!r} is not ported (only its "
                             f"default {default!r} is)")
    cls = ModelConfig if "n_neurons" in d else NewtonConfig
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"fields unknown to {cls.__name__}: {sorted(unknown)}")
    return cls(**d)


def params_from_numpy(beta, sigma, dtype: str = "float32",
                      device=None) -> MapParams:
    """``MapParams`` from numpy or Python scalars."""
    return MapParams.create(float(np.asarray(beta)), float(np.asarray(sigma)),
                            dtype=dtype, device=device)


def tensor_from_numpy(a, dtype: Union[str, torch.dtype, None] = None,
                      device=None) -> torch.Tensor:
    """A contiguous tensor copy of a numpy array (or anything numpy reads),
    in ``dtype`` (a torch dtype or its name) on ``device``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype,
                        device=device)
