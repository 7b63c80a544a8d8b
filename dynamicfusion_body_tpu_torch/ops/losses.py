"""Robust losses and IRLS weights — counterpart of
``dynamicfusion_body_tpu/ops/losses.py``.

The reference defines huber/tukey helpers (core/util.py:50-60); its
solver relies on scipy's ``loss='huber'`` with f_scale=1
(core/fusion.py:389), which the Gauss-Newton solver reproduces through
:func:`huber_irls_weight`.
"""

from __future__ import annotations

import torch


def huber_irls_weight(r: torch.Tensor, f_scale: float = 1.0) -> torch.Tensor:
    """IRLS weight for scipy-style huber (rho(z)=z for z<=1 else 2√z-1,
    z=(r/f_scale)²): 1 inside, f_scale/|r| outside — reproduces scipy
    ``least_squares(loss='huber')`` as used at core/fusion.py:382-392."""
    a = torch.abs(r) / f_scale
    return torch.where(a <= 1.0, torch.ones_like(a),
                       1.0 / torch.clamp_min(a, 1e-30))


def huber_loss(x: torch.Tensor, c) -> torch.Tensor:
    """0.5 x² inside |x| <= c, else c(|x| − c/2) (reference
    core/util.py:50-54)."""
    a = torch.abs(x)
    return torch.where(a <= c, 0.5 * x * x, c * (a - 0.5 * c))


def tukey_biweight_loss(x: torch.Tensor, c) -> torch.Tensor:
    """x(1 − (x/c)²)² inside |x| <= c, else 0: the reference's form
    (core/util.py:56-60), not the textbook rho."""
    return torch.where(torch.abs(x) > c, torch.zeros_like(x),
                       x * (1.0 - (x / c) ** 2) ** 2)


def tukey_irls_weight(r: torch.Tensor, c) -> torch.Tensor:
    """Tukey biweight IRLS weight: (1 − (r/c)²)² inside, 0 outside."""
    z = (r / c) ** 2
    return torch.where(z <= 1.0, (1.0 - z) ** 2, torch.zeros_like(z))
