"""Readings that the limits of ``correct`` are set from, for a refinement
cell, at the cell's own size.  For each seed, in one process: the set-up
of a run, the program's calls in float32, then one call of the program
with TF32 switched on (``torch.backends.cuda.matmul.allow_tf32``: the
control), each judged against the plain reference as a run judges it, from the map
the warm sweep left and from the raw map; beside them the reference
against itself, the planted faults (the map left unchanged, the first
phase left out, half of each phase's windows left out) and the reference
with every product rounded to TF32, each put in the program's place.

    python3 perfbench/calibrate.py --workload <cell> --calls <n> \
        --seeds <n> [<n> ...] [--out FILE]

Prints one JSON line per seed.  Not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def tf32_call(cell):
    """One call of the program with TF32 on: the control."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cell.call()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def load_map(cell, edges, lms):
    """Put a map in the engine's place, through the port's own wholesale
    upload (the global PGO's write-back), priors kept."""
    st = cell.engine.state
    E, L = st.num_edges, st.num_lms
    st.k2k_pose[:E] = edges
    st.lm_state[:L] = lms
    cell.engine.device_master.upload_from_host(
        st.k2k_pose, st.lm_state, E, L, k2k_prior=st.k2k_prior,
        k2k_prior_w=st.k2k_prior_w)


def readings(cell, calls):
    """Every compared number of each candidate, by name."""
    import torch
    from reference import srba_sweep

    raw = cell._read_map()
    cell.warm()                          # states[0]: after the warm sweep
    for _ in range(calls):
        cell.call()
    tf32_call(cell)
    load_map(cell, *raw)
    tf32_call(cell)                      # from the raw map
    st = cell.states
    # Index i: the map the program's call i started from; i + 1 its result.
    st[:] = [raw] + st[:calls + 2] + [raw, st[calls + 2]]
    cell.release()
    p = cell.problem()
    windows = srba_sweep.plan_windows(p)
    out = {"edge_mismatches": cell.edge_mismatches(p),
           "prior_gaps": cell.prior_gaps,
           "start_mismatches": cell.start_mismatches(p),
           "windows": len(windows),
           "program_windows": [i["windows"] for i in cell.infos]}

    def judge(name, call, ref, cand):
        t0 = time.perf_counter()
        out[name] = dict(cell.gaps(p, windows, ref, cand), call=call,
                         seconds=time.perf_counter() - t0)

    def other(call, **k):
        return cell.reference_sweep(p, windows, call, **k).to(torch.float64)

    half = [w for i, w in enumerate(windows) if i % 2 == 0]
    for call, tag in ((0, "raw"), (1, "warm")):
        t0 = time.perf_counter()
        ref = cell.reference_sweep(p, windows, call)
        out[f"reference_s_{tag}"] = time.perf_counter() - t0
        judge(f"program_from_{tag}", call, ref, cell.state_of(call + 1))
        judge(f"fault_unchanged_{tag}", call, ref, cell.state_of(call))
        judge(f"fault_first_phase_out_{tag}", call, ref,
              other(call, phases=(1,)))
        t0 = time.perf_counter()
        ref_half = cell.reference_sweep(p, half, call).to(torch.float64)
        judge(f"fault_half_windows_{tag}", call, ref, ref_half)
        if tag == "raw":
            judge("reference_again_raw", call, ref, other(call))
            judge("reference_tf32_rounded_raw", call, ref,
                  other(call, tf32=True))
    for c in range(2, calls + 1):
        judge(f"program_call{c}", c, cell.reference_sweep(p, windows, c),
              cell.state_of(c + 1))
    c = calls + 1
    judge("control_program_tf32_warm", c, cell.reference_sweep(p, windows, c),
          cell.state_of(c + 1))
    c = calls + 3
    judge("control_program_tf32_raw", c, cell.reference_sweep(p, windows, c),
          cell.state_of(c + 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch
    import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell_spec = harness.cell_spec(spec, args.workload)
    with open(os.path.join(HERE, "configs",
                           cell_spec["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell_spec["config"] + "."
                           + cell_spec["traffic"] + ".json")) as f:
        traffic = json.load(f)
    driver = harness.load_file(os.path.join(HERE, "drivers",
                                            traffic["driver"] + ".py"),
                               "perfbench_driver_" + traffic["driver"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = driver.Cell(config, traffic, seed, device)
        res = readings(cell, args.calls)
        res.update(seed=seed, seconds=time.perf_counter() - t0,
                   memory_peak_bytes=torch.cuda.max_memory_allocated(device))
        del cell
        torch.cuda.empty_cache()
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
