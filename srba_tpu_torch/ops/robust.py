"""Robust kernels — port of :mod:`srba_tpu.ops.robust` (the reference's
optional pseudo-Huber weighting, ``TSRBAParameters::use_robust_kernel`` /
``kernel_param``).

For squared whitened residual norm ``s = |r|^2`` the pseudo-Huber cost is
``rho(s) = 2 b^2 (sqrt(1 + s / b^2) - 1)`` and the IRLS row weight is
``w = rho'(s) = 1 / sqrt(1 + s / b^2)``; rows get scaled by ``sqrt(w)``.
"""

from __future__ import annotations

import torch


def pseudo_huber_weight(sq_norm, kernel_param):
    """Per-observation IRLS weight ``rho'(|r|^2)`` for pseudo-Huber."""
    b2 = kernel_param * kernel_param
    return 1.0 / torch.sqrt(1.0 + sq_norm / b2)


def pseudo_huber_cost(sq_norm, kernel_param):
    """Robustified total cost contribution for a squared residual norm."""
    b2 = kernel_param * kernel_param
    return 2.0 * b2 * (torch.sqrt(1.0 + sq_norm / b2) - 1.0)
