"""Synaptic coupling-kernel table (Mexican hat on a ring).

After the reference's half-domain rotation the table satisfies
``w[k] = dx * mexhat(min(k, N-k) * dx)``: the ring-periodic coupling as a
function of index distance, which the evolve step indexes with ``|i - j|``.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig


def mexican_hat(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Difference-of-exponentials kernel ``a1 e^{-b1|x|} - a2 e^{-b2|x|}``."""
    ax = torch.abs(x)
    return cfg.a1 * torch.exp(-cfg.b1 * ax) - cfg.a2 * torch.exp(-cfg.b2 * ax)


def coupling_kernel(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Tabulated ring coupling ``w``, shape ``(n_neurons,)``.

    ``w[i] = mexhat(-L + dx*i) * dx`` rotated left by ``N/2`` so that entry
    ``k`` holds the kernel at ring index-distance ``k``.
    """
    x = -cfg.half_width + cfg.dx * torch.arange(
        cfg.n_neurons, dtype=cfg.torch_dtype, device=device)
    w = mexican_hat(x, cfg) * cfg.dx
    return torch.roll(w, -(cfg.n_neurons // 2))


def coupling_row(w: torch.Tensor, j: int) -> torch.Tensor:
    """Coupling received by every neuron ``i`` when neuron ``j`` fires:
    ``w[|i - j|]``, which equals ``w[(i - j) mod N]`` because the table is
    even in index distance."""
    return torch.roll(w, int(j))
