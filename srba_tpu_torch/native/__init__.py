"""Native (C++) host graph service — build and ctypes binding; the port of
:mod:`srba_tpu.native`.

``graph_core.cpp`` (a byte copy of the JAX package's) is compiled with
``g++`` on first use into ``build/native/`` at the root of the checkout,
cached by a hash of the source and the flags.  It is integer bookkeeping on
the host (the keyframe graph, bounded spanning trees, the per-keyframe
window builder), bound as a plain C ABI through ctypes.

Where no ``g++`` exists the engine builds its windows with the Python
builder (``srba_tpu_torch.solver.window``) and this module says so once on
stderr; a failing build raises.  ``SRBA_TPU_TORCH_NO_NATIVE=1`` opts out
(the JAX package's ``SRBA_TPU_NO_NATIVE``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "graph_core.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NO_NATIVE_ENV = "SRBA_TPU_TORCH_NO_NATIVE"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# What the last build ran: {"cmd", "so", "digest"} (None before a build).
build_info: Optional[dict] = None


def source_digest() -> str:
    """Hash of the source and the compiler flags: the cache key of the
    built library."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Optional[Path]:
    """Build ``graph_core.cpp`` into ``build/native/`` (cached by
    :func:`source_digest`) and return the library's path; None when no
    ``g++`` exists.  Raises if the compiler fails."""
    global build_info
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    digest = source_digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"libsrba_graph_{digest}.so"
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(so_path)]
    if not so_path.exists():
        tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}")
        proc = subprocess.run(cmd[:-1] + [str(tmp)], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so_path)
    build_info = {"cmd": " ".join(cmd), "so": str(so_path),
                  "digest": digest}
    return so_path


def _load(so_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so_path))
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.srba_core_new.restype = ctypes.c_void_p
    lib.srba_core_new.argtypes = [ctypes.c_int]
    lib.srba_core_free.argtypes = [ctypes.c_void_p]
    lib.srba_core_add_kf.argtypes = [ctypes.c_void_p]
    lib.srba_core_add_edge.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int]
    lib.srba_core_add_lm.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.srba_core_add_obs.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.srba_core_num_edges.argtypes = [ctypes.c_void_p]
    lib.srba_core_bfs_tree.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ip, ip, ip, ip]
    lib.srba_core_path.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ip, ip]
    lib.srba_core_build_window.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ip, ip, ip, ip, ip, ip, ip, ip, ip, ip]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built at the first call; None when
    ``SRBA_TPU_TORCH_NO_NATIVE`` is set or no ``g++`` exists (the latter
    said once on stderr)."""
    global _LIB, _TRIED
    if os.environ.get(NO_NATIVE_ENV):
        return None
    with _LOCK:
        if not _TRIED:
            so_path = build_library()
            if so_path is None:
                print("srba_tpu_torch.native: no g++ found; windows are "
                      "built by the Python builder", file=sys.stderr)
            else:
                _LIB = _load(so_path)
            _TRIED = True
    return _LIB
