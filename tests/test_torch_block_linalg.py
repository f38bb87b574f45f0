"""Batched SPD block inverse: the port's plain torch version (what
``spd_inverse`` runs on a CPU tensor) against the JAX package's unrolled
form and against the TPU kernel body itself, run by the Pallas interpreter.

Tolerance rtol 2e-4 / atol 2e-5: the tolerance of the JAX package's own
block tests (tests/test_block_linalg.py); the operation order is the same
but f32 rounding of sqrt/div may differ between the backends.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from srba_tpu.ops import block_linalg as jbl
from srba_tpu_torch.ops import block_linalg as tbl

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _spd_stack(B, d, seed=0, cond=5.0):
    """The SPD stacks of tests/test_block_linalg.py."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + cond * np.eye(d, dtype=np.float32)


@functools.partial(jax.jit, static_argnums=(1,))
def _pallas_interpret(m2, d):
    """The TPU kernel (srba_tpu.ops.block_linalg._spd_inverse_kernel) over a
    streams-major [d*d, B] stack, B a multiple of its 2048-lane tile, run
    by the Pallas interpreter — the call of _spd_inverse_pallas_impl with
    interpret=True."""
    B, TB = m2.shape[1], 2048
    return pl.pallas_call(
        jbl._spd_inverse_kernel(d),
        out_shape=jax.ShapeDtypeStruct((d * d, B), m2.dtype),
        grid=(B // TB,),
        in_specs=[pl.BlockSpec((d * d, TB), lambda i: (0, i))],
        out_specs=pl.BlockSpec((d * d, TB), lambda i: (0, i)),
        interpret=True,
    )(m2)


def _tpu_kernel_reference(M):
    """spd_inverse_pallas's padding and layout around the interpreted
    kernel: pad B with identity blocks to the tile, transpose in and out."""
    B, d = M.shape[0], M.shape[-1]
    TB = 2048
    Bp = ((B + TB - 1) // TB) * TB
    m2 = M.reshape(B, d * d)
    if Bp != B:
        eye = np.broadcast_to(np.eye(d, dtype=M.dtype).reshape(1, d * d),
                              (Bp - B, d * d))
        m2 = np.concatenate([m2, eye], axis=0)
    out = np.asarray(_pallas_interpret(jnp.asarray(m2.T), d))
    return out.T[:B].reshape(B, d, d)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("B", [1, 7, 300, 2048])
def test_plain_matches_jax_unrolled_and_tpu_kernel(B, d):
    M = _spd_stack(B, d)
    out = tbl.spd_inverse(torch.from_numpy(M)).numpy()
    ref_unrolled = np.asarray(jbl.spd_inverse_unrolled(jnp.asarray(M)))
    np.testing.assert_allclose(out, ref_unrolled, rtol=RTOL, atol=ATOL)
    ref_kernel = _tpu_kernel_reference(M)
    np.testing.assert_allclose(out, ref_kernel, rtol=RTOL, atol=ATOL)


def test_leading_batch_dims():
    M = _spd_stack(12, 3, seed=3).reshape(3, 4, 3, 3)
    out = tbl.spd_inverse(torch.from_numpy(M)).numpy()
    ref = np.asarray(jbl.spd_inverse_unrolled(jnp.asarray(M)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_matches_linalg_inv_at_solver_shape():
    """[64, 2, 2] is the shape config #1's Schur solve inverts."""
    M = torch.from_numpy(_spd_stack(64, 2, seed=5))
    np.testing.assert_allclose(tbl.spd_inverse(M).numpy(),
                               torch.linalg.inv(M).numpy(),
                               rtol=RTOL, atol=ATOL)
