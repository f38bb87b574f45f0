"""Run one cell of the benchmark of ``srba_tpu_torch`` and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
come from ``BENCHMARK.json`` and the files under ``perfbench/``.  The host
thread pools are fixed here, before numpy or torch is imported, to the
configuration's ``host_threads`` (at most the CPUs this process may use).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def host_threads(config_name: str) -> int:
    with open(os.path.join(HERE, "configs", config_name + ".json")) as f:
        want = int(json.load(f).get("host_threads", 1))
    return max(1, min(want, len(os.sched_getaffinity(0))))


def main(argv=None) -> int:
    args = parse(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    n = host_threads(cells[args.workload]["config"])
    for var in THREAD_VARS:
        os.environ[var] = str(n)
    # Kernel caches of libraries the port may load, at fixed paths inside
    # the checkout (the port builds its own into build/kernels and
    # build/native there).
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "perfbench", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "perfbench", "ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [HERE, ROOT]
    import harness
    return harness.main(spec, args.workload, args.seed, args.seconds,
                        bool(args.trace), threads=n, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
