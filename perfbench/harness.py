"""The benchmark's run: set-up, the measured window, the check of the
outputs and the result line.  ``run.py`` is the command; tests call
:func:`run_cell` directly.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name: ``configs/<config>.json``,
``traffic/<config>.<traffic>.json`` (which names its driver,
``drivers/<driver>.py``) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

import tracing

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "srba_tpu")
HBM_BYTES_PER_S = 3.35e12     # one H100 SXM, NVIDIA's data sheet


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is one the benchmark may not
    load (compared whole: ``srba_tpu_torch`` is not ``srba_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def nvidia_smi() -> Optional[dict]:
    keys = ("name", "power.limit", "power.draw", "clocks.sm",
            "temperature.gpu")
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(keys),
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not proc.stdout.strip():
        return None
    vals = [v.strip() for v in proc.stdout.strip().splitlines()[0].split(",")]
    return dict(zip(keys, vals))


def cell_spec(spec: dict, workload: str) -> dict:
    """The workload's entry with its metrics: the end-to-end metrics it
    reports and the per-layer metrics read in it."""
    w = next(x for x in spec["workloads"] if x["name"] == workload)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return dict(w, end_to_end=e2e, per_layer=layer)


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device=None, sizes: Optional[dict] = None,
             t_start: Optional[float] = None, threads: int = 1,
             after_check=None) -> dict:
    """Set up, measure and check one cell; returns the result object.
    ``device`` None means the cell's chips must be CUDA devices (raises
    otherwise); tests pass ``torch.device("cpu")`` and small ``sizes``.
    ``after_check(cell, rng)``, where given, runs once the check is done
    and its dict goes into the result under ``calibration``
    (``calibrate.py`` reads the control there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell_spec(spec, workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            raise RuntimeError(f"{workload} needs {cell['chips']} CUDA "
                               f"device(s); found "
                               f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    torch.set_num_threads(threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(HERE, "configs", cell["config"] + ".json")) as f:
        config = json.load(f)
    traffic_name = f"{cell['config']}.{cell['traffic']}"
    with open(os.path.join(HERE, "traffic", traffic_name + ".json")) as f:
        traffic = json.load(f)
    driver = load_file(os.path.join(HERE, "drivers",
                                    traffic["driver"] + ".py"),
                       "perfbench_driver_" + traffic["driver"])
    cuda = device.type == "cuda"

    # Set-up: inputs from the seed, the system, every shape warmed.
    sut = driver.Cell(config, traffic, seed, device, sizes)
    sut.warm()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    gc.collect()
    gc.freeze()

    smi_before = nvidia_smi() if cuda else None
    launches0 = dict(_launches())
    prof = None
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            stack.enter_context(sut.traced())
            prof = stack.enter_context(profile(activities=[
                ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])))
        # A traced run profiles at most trace_calls calls.
        most = sut.trace_calls if trace else float("inf")
        t0 = time.perf_counter()
        n = 0
        while n < most:
            sut.call()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    summary = tracing.summarize(prof) if trace else None
    del prof
    smi_after = nvidia_smi() if cuda else None
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()
                if v - launches0.get(k, 0)}
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    gc.unfreeze()

    readings = dict(sut.readings(), calls=n, window_s=window_s,
                    trace=summary, launches_by_shape=launches,
                    memory_peak_bytes=peak, hbm_bytes_per_s=HBM_BYTES_PER_S)
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            reader = load_file(os.path.join(HERE, "metrics",
                                            m["name"] + ".py"),
                               "perfbench_metric_" + m["name"])
            value = reader.read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        timed = {"setup_s": setup_s, sut.metric: window_s / n}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": float(timed[m["name"]]),
                                  "unit": m["unit"]}

    sut.release()
    rng = np.random.default_rng([seed, 7])
    t_check = time.perf_counter()
    checks = sut.check(rng, traffic["limits"])
    check_s = time.perf_counter() - t_check
    correct = all(v <= lim for _, v, lim in checks)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]) if cuda else 0,
           "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=window_s)
    result = {"correct": bool(correct), "attempted": int(sut.attempted),
              "failed": int(sut.failed), "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["run"] = {"seed": seed, "seconds": seconds, "calls": n,
                     "window_s": window_s, "setup_s": setup_s,
                     "check_s": check_s,
                     "threads": threads, "nvidia_smi_before": smi_before,
                     "nvidia_smi_after": smi_after,
                     "launches_by_shape": {f"{b}x{d}x{d}": c for (b, d), c
                                           in sorted(launches.items())}}
    if after_check is not None:
        result["calibration"] = after_check(sut, rng)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def _launches() -> dict:
    mod = sys.modules.get("srba_tpu_torch.ops.block_linalg")
    if mod is None:
        return {}
    return dict(mod.spd_inverse_cuda.launches_by_shape)


def main(spec, workload, seed, seconds, trace, *, threads, t_start) -> int:
    try:
        result = run_cell(spec, workload, seed, seconds, trace,
                          threads=threads, t_start=t_start)
    except RuntimeError:
        traceback.print_exc()
        return 3
    bad = forbidden_modules()
    if bad:
        print("perfbench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
