"""Batched small-block SPD inverse — port of :mod:`srba_tpu.ops.block_linalg`.

The solvers invert stacks of ``[B, d, d]`` symmetric positive-definite
blocks with d in {1, 2, 3, 6} (the Schur landmark blocks of the window
solve; the block-Jacobi preconditioner of the global PGO).  Two versions of
the same arithmetic:

* :func:`spd_inverse_unrolled` — the plain torch version: an unrolled
  Cholesky, triangular inverse and ``L^-T L^-1`` product whose every step is
  one elementwise op over the batch.  It is the CPU path and the reference
  the kernel is held against.
* :func:`spd_inverse_cuda` — the hand-written CUDA kernel
  (``srba_tpu_torch/csrc/spd_inverse.cu``, the port of the TPU kernel
  ``srba_tpu/ops/block_linalg.py::_spd_inverse_kernel``), built with nvcc
  at first use into ``build/kernels/`` and bound with ctypes.  The kernel
  works out its own launch geometry (:func:`kernel_tile` reads the blocks
  each CTA takes).

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

_CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DIMS = (1, 2, 3, 6)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def kernel_sources(csrc_dir: Path = _CSRC_DIR) -> list[Path]:
    """Every file of ``csrc_dir`` the build reads: the ``.cu`` files it
    compiles and the headers they may include."""
    return sorted(p for p in Path(csrc_dir).iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def source_digest(csrc_dir: Path = _CSRC_DIR) -> str:
    """Hash of every source the build reads (names and bytes) and of the
    nvcc flags: the cache key of the built library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in kernel_sources(csrc_dir):
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build_kernel_library(csrc_dir: Path = _CSRC_DIR) -> Path:
    """Build the ``.cu`` files of ``csrc_dir`` with nvcc for sm_90a into one
    shared library under ``build/kernels/``, cached by
    :func:`source_digest`, and return its path.  The ``-Xptxas -v`` report
    (registers, shared memory and spills per kernel) is kept beside it
    with the suffix ``.ptxas.txt``.  Raises if the build fails."""
    digest = source_digest(csrc_dir)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _BUILD_DIR / f"libsrba_spd_inverse_{digest}.so"
    if not so_path.exists():
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(p) for p in kernel_sources(csrc_dir)
                 if p.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        ptxas_report(so_path).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so_path)
    return so_path


def ptxas_report(so_path: Path) -> Path:
    """Where :func:`build_kernel_library` keeps nvcc's ``-Xptxas -v``
    output for the library at ``so_path``."""
    return so_path.with_name(so_path.name + ".ptxas.txt")


@functools.lru_cache(maxsize=None)
def load_kernel_library() -> ctypes.CDLL:
    """Build ``csrc/`` (see :func:`build_kernel_library`) and load it.
    Raises if the build or the load fails."""
    lib = ctypes.CDLL(str(build_kernel_library()))
    lib.srba_spd_inverse_f32.restype = ctypes.c_int
    lib.srba_spd_inverse_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.srba_spd_inverse_tile.restype = ctypes.c_int
    lib.srba_spd_inverse_tile.argtypes = [ctypes.c_int]
    lib.srba_cuda_error_string.restype = ctypes.c_char_p
    lib.srba_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def kernel_tile(d: int) -> int:
    """Blocks of size ``d`` that one CTA of the kernel takes (0 for a d it
    does not take), as the built kernel reports it."""
    return load_kernel_library().srba_spd_inverse_tile(d)


def _check_blocks(m: torch.Tensor) -> int:
    """Raises on what the kernel does not take; returns d."""
    if not m.is_cuda:
        raise ValueError(f"spd_inverse_cuda needs a CUDA tensor, got "
                         f"{m.device}")
    if m.dtype != torch.float32:
        raise TypeError(f"spd_inverse_cuda needs float32, got {m.dtype}")
    shape = m.shape
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"expected [..., d, d] blocks, got {tuple(shape)}")
    d = shape[-1]
    if d not in _DIMS:
        raise ValueError(f"block size d={d} not in {_DIMS}")
    if not m.is_contiguous():
        raise ValueError("spd_inverse_cuda needs a contiguous tensor")
    return d


def spd_inverse_cuda(m: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel on ``m`` ([..., d, d] f32, contiguous, on a CUDA
    device, d in {1, 2, 3, 6}), launched on the current stream into ``out``
    (same shape, type and device, contiguous; a new tensor by default),
    which it returns.  Either pointer may sit at any float offset (a view
    into a larger stack): 16-byte aligned ones take 16-byte copies, others
    4-byte ones, with bitwise-equal results.  Raises on any other input and
    on a failed build or launch.  Each launch adds one to
    ``spd_inverse_cuda.launches_by_shape[(B, d)]``, the count per stack of
    B blocks of size d."""
    d = _check_blocks(m)
    if out is None:
        out = torch.empty_like(m)
    elif (out.shape != m.shape or out.dtype != m.dtype
          or out.device != m.device or not out.is_contiguous()):
        raise ValueError("spd_inverse_cuda: out must be a contiguous tensor "
                         "of m's shape, type and device")
    # Host time per call is what the keyframe path's small stacks cost, so
    # this path avoids Python work: no device switch when m is on the
    # current device, and the current stream's raw handle from one call
    # (the one PyTorch's own generated kernels launch with).
    dev = m.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return spd_inverse_cuda(m, out)
    B = m.numel() // (d * d)
    if B == 0:
        return out
    lib = load_kernel_library()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = lib.srba_spd_inverse_f32(m.data_ptr(), out.data_ptr(), B, d, stream)
    if rc != 0:
        raise RuntimeError(
            "spd_inverse kernel launch failed: "
            f"{lib.srba_cuda_error_string(rc).decode()} (cudaError {rc}) "
            f"at [{B},{d},{d}]")
    by_shape = spd_inverse_cuda.launches_by_shape
    by_shape[(B, d)] = by_shape.get((B, d), 0) + 1
    return out


spd_inverse_cuda.launches_by_shape = {}


def spd_inverse(m: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse [..., d, d]: the CUDA kernel for a CUDA tensor,
    the plain unrolled version for a CPU tensor."""
    if m.device.type == "cuda":
        return spd_inverse_cuda(m)
    if m.device.type == "cpu":
        return spd_inverse_unrolled(m)
    raise ValueError(f"spd_inverse: unsupported device {m.device}")
