"""Building blocks the global PGO (:mod:`srba_tpu_torch.solver.global_graphslam`)
and its chordal initializer (:mod:`srba_tpu_torch.solver.chordal`) share.
The JAX package has no counterpart module: these replace
``jax.ops.segment_sum`` and ``lax.while_loop`` there.

* :class:`EdgeIncidence` — deterministic segment sums over edge endpoints.
  ``index_add_``/``scatter_add_`` sum duplicate indices with atomics on
  CUDA, in an order that changes from run to run, and the one-hot matmul the
  window solver uses is out of reach at PGO sizes (one ``[32768, 32768]``
  f32 one-hot is 4 GiB).  Instead a per-node table of incident edge
  endpoints, built once per solve on the host, gathers every node's
  contributions into a ``[K, width]`` block (pad slots point at a zero row)
  and sums them in a fixed order.
* :func:`pcg` — (preconditioned) conjugate gradients with the JAX loop's
  early exit on relative residual, run as a host loop that reads the exit
  test every trip (:class:`HostReads` counts those reads), so it stops at
  the iteration where the JAX ``while_loop`` does.
"""

from __future__ import annotations

import numpy as np
import torch

class HostReads:
    """Blocking device->host reads of a solve's loop-exit tests, counted."""

    def __init__(self):
        self.n = 0

    def flag(self, t: torch.Tensor) -> bool:
        self.n += 1
        return bool(t)


class EdgeIncidence:
    """Per-node incidence table of edge endpoints for deterministic segment
    sums on ``device``.

    ``ea``/``eb`` (host int arrays, the first ``len(ea)`` rows of a table of
    ``num_edges`` edges) are the live edges; rows beyond them (weight-0
    padding, whose contributions are exact zeros) are left out, so the
    table is as wide as the highest live degree.  Slot ``e`` is edge ``e`` at
    its ``a`` end, slot ``num_edges + e`` the same edge at its ``b`` end,
    slot ``2 * num_edges`` a zero row."""

    def __init__(self, ea, eb, num_nodes: int, num_edges: int, device):
        ea = np.asarray(ea, np.int64)
        eb = np.asarray(eb, np.int64)
        n = ea.shape[0]
        nodes = np.concatenate([ea, eb])
        slots = np.concatenate([np.arange(n), num_edges + np.arange(n)])
        order = np.argsort(nodes, kind="stable")
        nodes, slots = nodes[order], slots[order]
        counts = np.bincount(nodes, minlength=num_nodes)
        width = max(int(counts.max()) if n else 0, 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(nodes.shape[0]) - starts[nodes]
        table = np.full((num_nodes, width), 2 * num_edges, np.int64)
        table[nodes, pos] = slots
        self.width = width
        self.table = torch.as_tensor(table, device=device)

    def sum(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        """``segment_sum(xa, ea) + segment_sum(xb, eb)`` over ``num_nodes``
        segments, for per-edge rows ``xa``/``xb`` ``[num_edges, ...]``."""
        x = torch.cat([xa, xb, xa.new_zeros((1,) + tuple(xa.shape[1:]))])
        return x[self.table].sum(dim=1)


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def pcg(Hv, precond, rhs, x0, iters: int, rtol: float, reads: HostReads):
    """Preconditioned CG for ``H x = rhs`` from ``x0`` with JAX's stopping
    rule: at most ``iters`` iterations, early exit once
    ``|r| <= rtol * |rhs|``, the test read on the host before every trip.
    Returns ``(x, iterations)``."""
    r = rhs - Hv(x0)
    x = x0
    z = precond(r)
    p = z
    rz = vdot(r, z)
    thresh = rtol * (torch.sqrt(vdot(rhs, rhs)) + 1e-30)
    it = 0
    while it < iters and reads.flag(torch.sqrt(vdot(r, r)) > thresh):
        Hp = Hv(p)
        alpha = rz / (vdot(p, Hp) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = vdot(r, z)
        p = z + (rz_new / (rz + 1e-30)) * p
        rz = rz_new
        it += 1
    return x, it
