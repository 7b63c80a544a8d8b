"""IRLS weights — counterpart of ``dynamicfusion_body_tpu/ops/losses.py``
(the part the non-rigid solver uses)."""

from __future__ import annotations

import torch


def huber_irls_weight(r: torch.Tensor, f_scale: float = 1.0) -> torch.Tensor:
    """IRLS weight for scipy-style huber (rho(z)=z for z<=1 else 2√z-1,
    z=(r/f_scale)²): 1 inside, f_scale/|r| outside — reproduces scipy
    ``least_squares(loss='huber')`` as used at core/fusion.py:382-392."""
    a = torch.abs(r) / f_scale
    return torch.where(a <= 1.0, torch.ones_like(a),
                       1.0 / torch.clamp_min(a, 1e-30))
