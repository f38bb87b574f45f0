"""Measuring helpers for the SPD block-inverse kernel on one NVIDIA GPU,
used by ``chip_smoke.py`` phases 2, 3 and 11 (:func:`measure_shape` gives
phase 3's numbers at one shape).

Two timing methods, never mixed in one comparison:

* *per call* (:func:`cuda_time_ms`): CUDA events around 200 back-to-back
  calls of a Python function on one input, median of 5 — the kernel's
  wrapper, the plain torch version and ``torch.linalg.inv_ex`` alike (the
  method of the earlier ``chip_smoke.py`` times).  It includes the host's
  work per call, which is what the keyframe path's small stacks cost;
* *device* time of the kernel alone: a CUDA graph of 200 launches,
  replayed 5 times, the median per launch (:func:`graph_time_ms`).
  *Cold*: L2 is flushed (a 2.5 x 50 MB buffer rewritten) before each
  replay and the launches rotate over distinct input and output stacks,
  spanning more than twice the 50 MB L2 where a stack is large, so that
  every launch reads its input from HBM as the bound assumes.  *Warm*: one
  input and one output stack (what the PGO's caller sees: it hands over a
  stack it has just written).  Beside them the kernel's own duration per
  launch from ``torch.profiler``.

The bound is the HBM bound: d*d*8*B bytes (each input read once, each
output written once) over 3.35 TB/s (H100 SXM, NVIDIA's data sheet); the
kernel's ~d^3 flops per block are far below the compute bound.  The library
yardstick is ``torch.linalg.inv_ex``, which the port never calls.  Imports
no JAX.
"""

from __future__ import annotations

import hashlib
import re
import statistics

import numpy as np
import torch

from srba_tpu_torch.ops import block_linalg as bl

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 1024 * 1024
# Where the HBM bound is under this, the launch (~2 us) dominates and no
# share of the bound is stated.
LAUNCH_BOUND_US = 0.5
# chip_smoke.py phase 3's shapes: the keyframe path's Schur blocks (config
# #3's windows reach L = 256), config #4's and config #3's PGO, config #5's
# at 1000 and 5000 keyframes, a large window's blocks and the PGO stacks.
SHAPES = ((64, 2), (64, 3), (256, 3), (512, 6), (1024, 6), (4096, 2),
          (8192, 6), (32768, 3), (32768, 6), (131072, 3), (131072, 6))


def bound_us(B: int, d: int) -> float:
    """HBM bound of one launch on [B, d, d], in microseconds."""
    return d * d * 8 * B / HBM_BYTES_PER_S * 1e6


def cold_stacks(B: int, d: int, iters: int) -> int:
    """Distinct input/output stack pairs a cold run rotates over: enough
    that they span 2.5 x L2, at most one per launch (L2 is flushed before
    each replay, so ``iters`` distinct small stacks are all cold)."""
    pair = 2 * B * d * d * 4
    return max(2, min(iters, -(-int(2.5 * L2_BYTES) // pair)))


def spd_stack(B, d, seed=0, cond=5.0):
    """SPD test stacks as in tests/test_block_linalg.py."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + cond * np.eye(d, dtype=np.float32)


def device_spd_stacks(n, B, d, seed=0, cond=5.0):
    """[n, B, d, d] SPD stacks made on the card from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(n * B, d, d, generator=g, device="cuda")
    m = A @ A.transpose(1, 2) + cond * torch.eye(d, device="cuda")
    return m.reshape(n, B, d, d)


def cuda_time_ms(fn, x, iters=200, repeats=5):
    """Median over ``repeats`` of the mean time per call of ``fn(x)`` over
    ``iters`` back-to-back calls, by CUDA events (warmed up first)."""
    for _ in range(10):
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn(x)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


def graph_time_ms(launch, iters=200, repeats=5, flush=None):
    """Median over ``repeats`` replays of a CUDA graph of ``launch(j)`` for
    j < ``iters``, per launch, by CUDA events; ``flush()`` runs before each
    replay, outside the timed span."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for j in range(3):
            launch(j)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for j in range(iters):
            launch(j)
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


class KernelTimer:
    """Cold and warm device times of a launcher ``launch(m, out)`` on
    [B, d, d]."""

    def __init__(self, iters=200, repeats=5):
        self.iters, self.repeats = iters, repeats
        self._flush_buf = torch.empty(int(2.5 * L2_BYTES) // 4,
                                      device="cuda")

    def flush(self):
        self._flush_buf.fill_(1.0)

    def cold_ms(self, launch, B, d, seed=1):
        n = cold_stacks(B, d, self.iters)
        ins = device_spd_stacks(n, B, d, seed)
        outs = torch.empty_like(ins)
        return graph_time_ms(lambda j: launch(ins[j % n], outs[j % n]),
                             self.iters, self.repeats, self.flush)

    def warm_ms(self, launch, m):
        out = torch.empty_like(m)
        return graph_time_ms(lambda j: launch(m, out), self.iters,
                             self.repeats)


def profiled_device_us(fn, x, iters=50):
    """Mean device time per launch of the kernels named ``spd_inverse*``
    that ``fn(x)`` runs, from ``torch.profiler``; None if the trace holds
    no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(x)
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if "spd_inverse" not in ev.key:
            continue
        t = ev.device_time_total
        if t > 0:
            total += t
            count += ev.count
    return total / count if count else None


def ptxas_summary(report: str):
    """(kernel, registers, static shared memory bytes, spill store bytes,
    spill load bytes) for each entry function of nvcc's ``-Xptxas -v``
    report, the kernel named as ``spd_inverse_staged<6,1>`` (its template
    arguments: D, and 1 where its pointers are 16-byte aligned)."""
    rows, name, spills = [], None, (None, None)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*(spd_inverse_"
                      r"(?:staged|d\d))I(\w*?)EEvPKfPfx'", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
            name = f"{m.group(1)}<{','.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)),
                         int(smem.group(1)) if smem else 0, *spills))
            name = None
    return rows


def output_digest(out: torch.Tensor) -> str:
    """SHA-256 of a result's bytes, to show bitwise equality across runs."""
    return hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()


def measure_shape(B, d, timer: KernelTimer):
    """Phase 3's numbers at [B, d, d]: per call (the kernel's wrapper, the
    plain version and ``torch.linalg.inv_ex``), the kernel's device time
    (cold, warm and on the profiler), the bound, the share of it (cold,
    large stacks only) and the digest of the kernel's output on
    ``spd_stack(B, d)``."""
    m = torch.as_tensor(spd_stack(B, d), device="cuda")
    out = bl.spd_inverse_cuda(m)
    r = {"bound_us": bound_us(B, d),
         "ms": cuda_time_ms(bl.spd_inverse_cuda, m),
         "plain_ms": cuda_time_ms(bl.spd_inverse_unrolled, m),
         "library_ms": cuda_time_ms(torch.linalg.inv_ex, m),
         "cold_ms": timer.cold_ms(bl.spd_inverse_cuda, B, d),
         "warm_ms": timer.warm_ms(bl.spd_inverse_cuda, m),
         "device_us": profiled_device_us(bl.spd_inverse_cuda, m),
         "sha256": output_digest(out)}
    r["share"] = (r["bound_us"] / (1e3 * r["cold_ms"])
                  if r["bound_us"] >= LAUNCH_BOUND_US else None)
    return r


def format_shape(B, d, r) -> str:
    share = (f"{100 * r['share']:.1f}% of bound" if r["share"] is not None
             else "launch-bound")
    dev = (f"{r['device_us']:.2f}" if r["device_us"] is not None
           else "not measured")
    return (f"[{B},{d},{d}]: per call (200 back-to-back calls): kernel "
            f"{1e3 * r['ms']:.2f} us, plain torch "
            f"{1e3 * r['plain_ms']:.2f} us, torch.linalg.inv_ex "
            f"{1e3 * r['library_ms']:.2f} us; kernel device time per launch "
            f"(CUDA graph): cold {1e3 * r['cold_ms']:.2f} us, warm "
            f"{1e3 * r['warm_ms']:.2f} us, profiler {dev} us; bound "
            f"{r['bound_us']:.3f} us ({share})")
