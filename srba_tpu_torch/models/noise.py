"""Observation-noise models (port of :mod:`srba_tpu.models.noise`:
``NoiseIdentity`` and ``NoiseConstantMatrix``) — analog of the reference's
``options::observation_noise_identity`` / ``observation_noise_constant_matrix``
(public MRPT/srba layout: ``include/srba/options/obs_noise_*.h``; SURVEY.md §3).

Formulation: instead of carrying an information matrix ``Lambda``
into the normal equations (``J^T Lambda J``), every noise model produces a
static **whitening matrix** ``W = Lambda^{1/2}`` (Cholesky factor of the
information matrix).  Residual rows and Jacobian rows are multiplied by ``W``
once, after which the whole solver is plain unweighted least squares, and
the robust kernel composes as an extra scalar row weight.
"""

from __future__ import annotations

import numpy as np


class NoiseIdentity:
    """Isotropic noise with a single standard deviation (the reference's
    ``observation_noise_identity`` with its ``std_noise_observations``)."""

    name = "identity"

    def __init__(self, std: float = 1.0):
        self.std = float(std)

    def whitener(self, obs_dim: int) -> np.ndarray:
        return np.eye(obs_dim, dtype=np.float32) / self.std


class NoiseConstantMatrix:
    """Full constant covariance shared by all observations (the reference's
    ``observation_noise_constant_matrix``).  The whitener is host numpy,
    the same calls as the JAX package's, so the two are bitwise equal."""

    name = "constant_matrix"

    def __init__(self, cov: np.ndarray):
        self.cov = np.asarray(cov, dtype=np.float64)

    def whitener(self, obs_dim: int) -> np.ndarray:
        if self.cov.shape != (obs_dim, obs_dim):
            raise ValueError(f"noise covariance must be {obs_dim}x{obs_dim}, "
                             f"got {self.cov.shape}")
        info = np.linalg.inv(self.cov)
        # W^T W = info  =>  W = chol(info)^T so that |W r|^2 = r^T info r.
        return np.linalg.cholesky(info).T.astype(np.float32)
