"""Batched small-block SPD inverse — port of :mod:`srba_tpu.ops.block_linalg`.

The solver inverts stacks of ``[B, d, d]`` symmetric positive-definite
blocks with d in {1, 2, 3, 6} (the Schur landmark blocks; the global PGO
block-Jacobi preconditioner later).  Two versions of the same arithmetic:

* :func:`spd_inverse_unrolled` — the plain torch version: an unrolled
  Cholesky, triangular inverse and ``L^-T L^-1`` product whose every step is
  one elementwise op over the batch.  It is the CPU path and the reference
  the kernel is held against.
* :func:`spd_inverse_cuda` — the hand-written CUDA kernel
  (``srba_tpu_torch/csrc/spd_inverse.cu``, the port of the TPU kernel
  ``srba_tpu/ops/block_linalg.py::_spd_inverse_kernel``), built with nvcc
  at first use into ``build/kernels/`` and bound with ctypes.

:func:`spd_inverse` picks by the tensor's device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "spd_inverse.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DIMS = (1, 2, 3, 6)


def _chol_streams(m, d):
    """Unrolled Cholesky of [..., d, d] SPD blocks as d(d+1)/2 [...]-shaped
    streams.  Returns L as a dict {(i, j): stream} for i >= j."""
    L = {}
    for i in range(d):
        for j in range(i + 1):
            s = m[..., i, j]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            if i == j:
                L[(i, j)] = torch.sqrt(s)
            else:
                L[(i, j)] = s / L[(j, j)]
    return L


def _linv_streams(L, d):
    """Inverse of the lower-triangular L (unrolled forward substitution)."""
    Li = {}
    for j in range(d):
        Li[(j, j)] = 1.0 / L[(j, j)]
        for i in range(j + 1, d):
            s = 0.0
            for k in range(j, i):
                s = s + L[(i, k)] * Li[(k, j)]
            Li[(i, j)] = -s / L[(i, i)]
    return Li


def spd_inverse_unrolled(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a stack of small SPD matrices [..., d, d] via unrolled
    Cholesky (A^-1 = L^-T L^-1).  Pure elementwise ops over the batch."""
    d = m.shape[-1]
    if d == 1:
        return 1.0 / m
    L = _chol_streams(m, d)
    Li = _linv_streams(L, d)
    rows = []
    for i in range(d):
        cols = []
        for j in range(d):
            s = 0.0
            for k in range(max(i, j), d):
                s = s + Li[(k, i)] * Li[(k, j)]
            cols.append(s)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the SPD-inverse kernel is built "
            "from source at first use")
    return found


@functools.lru_cache(maxsize=None)
def load_kernel_library() -> ctypes.CDLL:
    """Build ``csrc/spd_inverse.cu`` with nvcc for sm_90a (cached under
    ``build/kernels/`` by a hash of the source) and load it.  Raises if the
    build or the load fails."""
    src = _CSRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _BUILD_DIR / f"libsrba_spd_inverse_{digest}.so"
    if not so_path.exists():
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(_CSRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.srba_spd_inverse_f32.restype = ctypes.c_int
    lib.srba_spd_inverse_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.srba_cuda_error_string.restype = ctypes.c_char_p
    lib.srba_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def spd_inverse_cuda(m: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``m`` ([..., d, d] f32, contiguous, on a
    CUDA device, d in {1, 2, 3, 6}) on the current stream.  Raises on any
    other input and on a failed build or launch.  Each launch adds one to
    ``spd_inverse_cuda.launches`` and to
    ``spd_inverse_cuda.launches_by_d[d]`` (the count per block size)."""
    if m.device.type != "cuda":
        raise ValueError(f"spd_inverse_cuda needs a CUDA tensor, got "
                         f"{m.device}")
    if m.dtype != torch.float32:
        raise TypeError(f"spd_inverse_cuda needs float32, got {m.dtype}")
    if m.dim() < 2 or m.shape[-1] != m.shape[-2]:
        raise ValueError(f"expected [..., d, d] blocks, got {tuple(m.shape)}")
    d = m.shape[-1]
    if d not in _DIMS:
        raise ValueError(f"block size d={d} not in {_DIMS}")
    if not m.is_contiguous():
        raise ValueError("spd_inverse_cuda needs a contiguous tensor")
    lib = load_kernel_library()
    out = torch.empty_like(m)
    B = m.numel() // (d * d)
    if B == 0:
        return out
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.srba_spd_inverse_f32(m.data_ptr(), out.data_ptr(), B, d,
                                      stream)
    if rc != 0:
        raise RuntimeError(
            "spd_inverse kernel launch failed: "
            f"{lib.srba_cuda_error_string(rc).decode()} (cudaError {rc})")
    spd_inverse_cuda.launches += 1
    by_d = spd_inverse_cuda.launches_by_d
    by_d[d] = by_d.get(d, 0) + 1
    return out


spd_inverse_cuda.launches = 0
spd_inverse_cuda.launches_by_d = {}


def spd_inverse(m: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse [..., d, d]: the CUDA kernel for a CUDA tensor,
    the plain unrolled version for a CPU tensor."""
    if m.device.type == "cuda":
        return spd_inverse_cuda(m)
    if m.device.type == "cpu":
        return spd_inverse_unrolled(m)
    raise ValueError(f"spd_inverse: unsupported device {m.device}")
