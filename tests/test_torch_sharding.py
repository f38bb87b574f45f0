"""The port's observation-sharded window solve (``srba_tpu_torch.parallel.
sharding``) against the JAX package's, on tests/test_sharding.py's window:
the two-keyframe problem of tests/test_solver.py.

For n in {2, 4, 8} the port's ``make_spmd_solver`` runs on a real n-rank
gloo ring (n processes on this CPU, ``jax`` blocked in each) and the JAX
package's on ``make_mesh(n)`` of the 8 virtual CPU devices in this process;
both are held to each other and to the port's unsharded solve at
tests/test_sharding.py's tolerances: edges and landmarks atol = rtol =
1e-4, ``err_final`` rel 1e-3, ``num_obs`` exactly, ``eval_error`` rel 1e-4.
The ranks sum their shards in rank order, so n > 1 is not bitwise n = 1;
the ranks' results are bitwise equal to each other.  A one-rank world is
bitwise the unsharded solve, and the solver makes exactly two all-reduce
rounds per LM iteration (normal equations, error) plus one for
``err_init`` and one for ``num_obs``.

``run_ring`` and ``one_rank_mesh`` serve tests/test_torch_multihost.py and
the tests whose mesh cases run on a one-rank world.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
RING_TIMEOUT = 120      # seconds per ring, the processes' communicate()
GROUP_TIMEOUT = 60      # seconds, every collective of a ring

# tests/test_solver.py's CFG in the port.
CFG = dict(obs_model="Cartesian2D", pose_group="SE2", lm_type="Euclidean2D",
           max_depth=3, max_iters=15)
WINDOW_FIELDS = ("edge_pose", "edge_opt", "lm_state", "lm_opt", "obs_z",
                 "obs_lm", "path_edge", "path_sign", "obs_valid", "whitener",
                 "sensor_pose_inv")


def run_ring(target: str, nprocs: int, tmp_path, *args):
    """Runs ``target`` ("module:function" of this repo), called as
    ``function(rank, nprocs, store, out, *args)``, in ``nprocs`` fresh
    interpreters where ``jax``, ``jaxlib``, ``flax`` and ``srba_tpu`` cannot
    be imported; ``store`` is a file for the ring's rendezvous.  Each rank
    writes ``{out}.{rank}.npz``; returns their contents, rank by rank.  A
    rank that fails or outlives ``RING_TIMEOUT`` fails the test."""
    module, fn = target.split(":")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'srba_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import importlib\n"
            f"getattr(importlib.import_module({module!r}), {fn!r})"
            "(*sys.argv[1:])\n")
    store, out = str(tmp_path / f"{fn}.store"), str(tmp_path / fn)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(nprocs), store, out,
         *map(str, args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(nprocs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RING_TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} failed (rc={p.returncode}):\n{logs[r][-4000:]}")
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(nprocs)]


def join_ring(rank, nprocs, store):
    """A ring rank's set-up: one thread, the gloo world on the file store,
    its mesh."""
    from srba_tpu_torch.parallel import make_mesh
    from srba_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    mh.initialize(f"file://{store}", int(nprocs), int(rank), device="cpu",
                  timeout=GROUP_TIMEOUT)
    return make_mesh()


def leave_ring():
    """A ring rank's teardown: wait for every rank, then close the process
    group (a gloo rank that exits with its group open can abort)."""
    import torch.distributed as dist

    from srba_tpu_torch.parallel import multihost as mh

    mh.sync_processes("done")
    dist.destroy_process_group()


def one_rank_mesh():
    """A mesh over a world of one rank on the CPU (gloo on an in-process
    store), made once per process and kept: the process group is
    process-wide."""
    from srba_tpu_torch.parallel import make_mesh
    from srba_tpu_torch.parallel import multihost as mh

    mh.initialize(device="cpu")
    return make_mesh(1, devices="cpu")


class CountAllReduce:
    """Counts ``torch.distributed.all_reduce`` calls while installed."""

    def __init__(self, dist):
        self.dist, self.calls = dist, 0
        self.inner = dist.all_reduce

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.inner(*args, **kwargs)

    def __enter__(self):
        self.dist.all_reduce = self
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.inner


def _port_batch(arrays: dict):
    from srba_tpu_torch.solver.lm import WindowBatch
    return WindowBatch(**{k: arrays[k] for k in WINDOW_FIELDS})


def solve_worker(rank, nprocs, store, out, batch_path):
    """One rank of the sharded solve: the full window from ``batch_path``,
    the solve, ``eval_error`` and the solve's all-reduce count."""
    import torch.distributed as dist

    from srba_tpu_torch.parallel import make_spmd_solver
    from srba_tpu_torch.solver.lm import SolverConfig

    mesh = join_ring(rank, nprocs, store)
    batch = _port_batch(dict(np.load(batch_path)))
    solve, eval_error = make_spmd_solver(SolverConfig(**CFG), mesh)
    with CountAllReduce(dist) as count:
        edge, lm, info = solve(batch)
    np.savez(f"{out}.{rank}.npz", edge=edge.numpy(), lm=lm.numpy(),
             eval_error=float(eval_error(batch)), all_reduces=count.calls,
             **{k: float(v) for k, v in info.items()})
    leave_ring()


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    """tests/test_sharding.py's window as host arrays, saved for the
    rings."""
    from tests.test_solver import _two_kf_problem
    from srba_tpu.solver.window import build_window

    state, graph, _, _ = _two_kf_problem(
        noise=0.005, edge_guess=[-0.9, -0.15, 0.05], seed=4)
    arrays, _ = build_window(state, graph, 1, 3, 3)
    host = {f: np.asarray(getattr(arrays, f)) for f in WINDOW_FIELDS[:9]}
    host["obs_lm"] = host["obs_lm"].astype(np.int32)
    host["path_edge"] = host["path_edge"].astype(np.int32)
    host["path_sign"] = host["path_sign"].astype(np.float32)
    host["whitener"] = np.eye(2, dtype=np.float32)
    host["sensor_pose_inv"] = np.zeros(3, np.float32)
    path = tmp_path_factory.mktemp("window") / "window.npz"
    np.savez(path, **host)
    return host, path


def _unsharded(host):
    from srba_tpu_torch.solver.lm import SolverConfig, make_lm_solver
    solve, eval_error = make_lm_solver(SolverConfig(**CFG), device="cpu")
    batch = _port_batch(host)
    return solve(batch), float(eval_error(batch))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_solve_matches_jax_and_unsharded(window, tmp_path, n):
    import jax

    from srba_tpu.parallel.sharding import (make_mesh, make_spmd_solver,
                                            shard_batch)
    from tests.test_solver import CFG as JCFG, _make_batch

    host, path = window
    assert host["obs_valid"].shape[0] % n == 0
    ranks = run_ring("tests.test_torch_sharding:solve_worker", n, tmp_path,
                     path)
    for r in ranks[1:]:   # the replicas agree bit for bit
        for k in ("edge", "lm", "err_final", "eval_error"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
    got = ranks[0]

    assert len(jax.devices()) >= n
    mesh = make_mesh(n)
    solve, eval_error = make_spmd_solver(JCFG, mesh)
    jb = _make_batch(types.SimpleNamespace(**host))
    e_j, l_j, info_j = solve(shard_batch(jb, mesh))
    (e_1, l_1, info_1), err_1 = _unsharded(host)

    for ref_e, ref_l in ((np.asarray(e_j), np.asarray(l_j)),
                         (e_1.numpy(), l_1.numpy())):
        np.testing.assert_allclose(got["edge"], ref_e, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["lm"], ref_l, atol=1e-4, rtol=1e-4)
    for ref in (float(info_j["err_final"]), float(info_1["err_final"])):
        assert float(got["err_final"]) == pytest.approx(ref, rel=1e-3,
                                                        abs=1e-7)
    assert float(got["num_obs"]) == float(info_j["num_obs"]) \
        == float(info_1["num_obs"])
    for ref in (float(eval_error(shard_batch(jb, mesh))), err_1):
        assert float(got["eval_error"]) == pytest.approx(ref, rel=1e-4,
                                                         abs=1e-8)
    # Two rounds per LM iteration (the loop runs max_iters trips), plus
    # err_init and num_obs.
    assert int(got["all_reduces"]) == 2 * CFG["max_iters"] + 2
    assert float(got["err_final"]) < float(got["err_init"])


def test_one_rank_world_is_bitwise_unsharded(window):
    import torch.distributed as dist

    from srba_tpu_torch.parallel import make_spmd_solver, shard_batch
    from srba_tpu_torch.solver.lm import SolverConfig

    host, _ = window
    mesh = one_rank_mesh()
    solve, eval_error = make_spmd_solver(SolverConfig(**CFG), mesh)
    batch = _port_batch(host)
    with CountAllReduce(dist) as count:
        edge, lm, info = solve(batch)
    assert count.calls == 2 * CFG["max_iters"] + 2
    (e_1, l_1, info_1), err_1 = _unsharded(host)
    assert torch.equal(edge, e_1) and torch.equal(lm, l_1)
    assert {k: float(v) for k, v in info.items()} == \
        {k: float(v) for k, v in info_1.items()}
    assert float(eval_error(batch)) == err_1
    # shard_batch on one rank: every row, on the rank's device.
    sb = shard_batch(batch, mesh)
    assert all(torch.equal(getattr(sb, f), torch.as_tensor(host[f]))
               for f in WINDOW_FIELDS)


def test_make_spmd_solver_is_cached_and_checks_divisibility(window):
    from srba_tpu_torch.parallel import make_spmd_solver, sharding
    from srba_tpu_torch.solver.lm import SolverConfig

    mesh = one_rank_mesh()
    cfg = SolverConfig(**CFG)
    assert make_spmd_solver(cfg, mesh) is make_spmd_solver(cfg, mesh)
    assert sharding.shard_rows(16, mesh) == slice(0, 16)

    class Two:
        def size(self):
            return 2

        def get_local_rank(self):
            return 1

    assert sharding.shard_rows(16, Two()) == slice(8, 16)
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_rows(15, Two())
    with pytest.raises(ValueError, match="whole world"):
        sharding.make_mesh(2)
    with pytest.raises(ValueError, match="make_spmd_solver"):
        from srba_tpu_torch.solver.lm import make_lm_solver
        make_lm_solver(dataclasses.replace(cfg, axis_name="obs"),
                       device="cpu")
