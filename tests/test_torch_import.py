"""srba_tpu_torch imports no JAX, runs only where it is told to, and names
what it has not ported yet."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _port_modules():
    mods = []
    for p in sorted((REPO / "srba_tpu_torch").rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return mods


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'srba_tpu'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_cuda_without_cuda_raises(monkeypatch):
    """No fallback: asking for CUDA where there is none raises."""
    from srba_tpu_torch import SrbaEngine
    from srba_tpu_torch.engine.device_master import DeviceMaster
    from srba_tpu_torch.solver.lm import SolverConfig, make_lm_solver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SrbaEngine("RangeBearing2D", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceMaster(3, 2, device="cuda")
    cfg = SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                       lm_type="Euclidean2D", max_depth=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_solver(cfg, device="cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors only; the plain version
    is chosen by spd_inverse for a CPU tensor, never by the wrapper."""
    from srba_tpu_torch.ops.block_linalg import spd_inverse_cuda
    m = torch.eye(2).repeat(4, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spd_inverse_cuda(m)


@pytest.mark.parametrize("what", [
    "observation", "group", "landmark", "solver", "neq", "engine_path"])
def test_unported_names_raise(what):
    from srba_tpu_torch import SrbaEngine
    from srba_tpu_torch.solver.lm import SolverConfig, make_solver_impl

    base = dict(obs_model="RangeBearing2D", pose_group="SE2",
                lm_type="Euclidean2D", max_depth=3)
    with pytest.raises(NotImplementedError) as ei:
        if what == "observation":
            # Every observation model of the JAX package is ported: a name
            # neither package has still raises by name through the lookup.
            SrbaEngine("OmnidirectionalCamera", device="cpu")
        elif what == "group":
            # Both of the JAX package's groups are ported: a name neither
            # package has still raises by name through the lookup.
            make_solver_impl(SolverConfig(**{**base, "pose_group": "Sim3"}))
        elif what == "landmark":
            make_solver_impl(SolverConfig(**{**base,
                                             "lm_type": "InverseDepth"}))
        elif what == "solver":
            # Both of the JAX package's solvers are ported: the reference's
            # sparse-Cholesky engine, which neither package has, still
            # raises by name.
            make_solver_impl(SolverConfig(
                **{**base, "solver": "schur_sparse_cholesky"}))
        elif what == "neq":
            make_solver_impl(SolverConfig(**{**base, "neq": "scatter"}))
        else:
            # Every engine path is ported, the mesh path last: it runs on a
            # one-rank gloo mesh (the host-window mode on the mesh's
            # device), and a name neither package has still raises.
            from tests.test_torch_sharding import one_rank_mesh
            eng = SrbaEngine("RangeBearing2D", mesh=one_rank_mesh(),
                             device="cpu")
            assert eng.device_master is None and eng.mesh is not None
            SrbaEngine("RangeBearing2D", lm_type="InverseDepth",
                       mesh=one_rank_mesh(), device="cpu")
    assert "not ported" in str(ei.value)


def test_unported_models_and_options_raise():
    """The monocular and RGB-D camera models and their calibration are
    ported: both construct and observe on the device-master path.  A
    calibration the port does not know still raises by name."""
    from srba_tpu_torch import SrbaEngine
    from srba_tpu_torch.models.observations import CameraCalib
    from srba_tpu_torch.utils.datasets import make_world_loop_3d, observe

    for name in ("MonocularCamera", "RGBDCamera"):
        eng = SrbaEngine(name, calib=CameraCalib.make(), device="cpu")
        assert eng.model.name == name and eng.device_master is not None
        ds = observe(make_world_loop_3d(num_kfs=4, num_landmarks=5), name,
                     calib=CameraCalib.make())
        assert len(ds.frames) == 4
    with pytest.raises(NotImplementedError, match="calibrated"):
        SrbaEngine("RangeBearing3D", calib=object(), device="cpu")


def test_closure_targets_raise():
    """Closure targets are served (a policy's closure target with too few
    voters for a fit gets an estimate-seeded edge, as in the JAX package),
    and the monocular closure fit runs: with fewer than 4 voters it is not
    applicable ("n/a")."""
    from srba_tpu_torch import Observation, SrbaEngine
    from srba_tpu_torch.engine.closure import bootstrap_closure_edge
    from srba_tpu_torch.models.observations import CameraCalib

    class ClosurePolicy:
        def edges_for_new_kf(self, state, graph, new_kf, obs_lm_ids):
            return ([new_kf - 1] if new_kf else []), ([0] if new_kf > 1
                                                        else [])

    eng = SrbaEngine("RangeBearing2D", ecp=ClosurePolicy(), device="cpu")
    for k in range(2):
        eng.define_new_keyframe(
            [Observation(lm_id=0, z=np.asarray([1.0, 0.1], np.float32))],
            edge_init={k - 1: [0.1, 0.0, 0.0]} if k else None)
    info = eng.define_new_keyframe([], edge_init={1: [0.1, 0.0, 0.0]})
    st = eng.get_rba_state()
    assert [(int(st.k2k_from[e]), int(st.k2k_to[e]))
            for e in info.created_edge_ids] == [(2, 1), (2, 0)]

    mono = SrbaEngine("MonocularCamera", calib=CameraCalib.make(),
                      device="cpu")
    mono.define_new_keyframe([Observation(
        lm_id=j, z=np.asarray([150.0 + j, 120.0], np.float32)) for j in
        range(3)])
    voters = [(lm, np.asarray([150.0, 120.0], np.float32))
              for lm in range(3)]
    for lm in range(3):
        mono._add_landmark(0, np.asarray([0.1 * lm, 0.0, 3.0], np.float32))
    status, T, _, _, _ = bootstrap_closure_edge(
        mono, 0, voters, np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32))
    assert (status, T) == ("n/a", None)


@pytest.mark.parametrize("mod", ["srba_tpu_torch.engine.closure",
                                 "srba_tpu_torch.engine.triangulate",
                                 "srba_tpu_torch.ecps",
                                 "srba_tpu_torch.models.observations",
                                 "srba_tpu_torch.models.sensor_pose",
                                 "srba_tpu_torch.utils.datasets"])
def test_closure_and_camera_modules_import_without_jax(mod):
    """Each module configs #3 and #5 added to or grew in the port, alone in
    a fresh interpreter, pulls in no jax, jaxlib, flax or srba_tpu
    module."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'srba_tpu'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_convert_defaults_to_cuda(monkeypatch):
    """Like every entry point, the state carriers default to the card (and
    raise where there is none)."""
    import inspect

    from srba_tpu_torch import convert
    for fn in (convert.window_batch_from_jax,
               convert.device_master_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

    class JDM:
        pose_dim, lm_dim = 3, 2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.device_master_from_jax(JDM())


@pytest.mark.parametrize("mod", ["srba_tpu_torch.solver.global_graphslam",
                                 "srba_tpu_torch.solver.chordal",
                                 "srba_tpu_torch.io.export"])
def test_pgo_modules_import_without_jax(mod):
    """Each module of the global PGO, alone in a fresh interpreter, pulls in
    no jax, jaxlib, flax or srba_tpu module."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'srba_tpu'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_unported_global_pgo_paths_raise():
    """The edge-sharded global PGO is ported (the last of the global PGO's
    paths): the engine's ``optimize_global(mesh=...)`` on a one-rank gloo
    mesh gives bitwise the unsharded solve of the same map."""
    from srba_tpu_torch import Observation, SrbaEngine
    from tests.test_torch_sharding import one_rank_mesh

    eng = SrbaEngine("RelativePoses2D", device="cpu")
    odo = np.asarray([1.0, 0.0, 0.3], np.float32)
    for k in range(6):
        eng.define_new_keyframe(
            [Observation(lm_id=k - 1, z=odo)] if k else [],
            edge_init={k - 1: odo} if k else None)
    G, info = eng.optimize_global(write_back=False)
    G_m, info_m = eng.optimize_global(write_back=False, mesh=one_rank_mesh())
    np.testing.assert_array_equal(G_m, G)
    assert info_m == info


@pytest.mark.parametrize("mod", ["srba_tpu_torch.solver.multi_window",
                                 "srba_tpu_torch.solver.lm",
                                 "srba_tpu_torch.models.kf2kf_poses",
                                 "srba_tpu_torch.models.noise",
                                 "srba_tpu_torch.engine.engine",
                                 "srba_tpu_torch.convert"])
def test_sweep_and_variant_modules_import_without_jax(mod):
    """Each module the host-window mode, the solver variants, refine_map,
    LocalAreasVar1 and NoiseConstantMatrix added to or grew in the port,
    alone in a fresh interpreter, pulls in no jax, jaxlib, flax or srba_tpu
    module."""
    code = (
        f"import importlib, sys\nimportlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'srba_tpu'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_public_entry_points_exported():
    """The new public names sit where the JAX package puts them."""
    import srba_tpu_torch as port
    from srba_tpu_torch import models, solver
    from srba_tpu_torch.ecps import ECPS, LocalAreasVar1
    from srba_tpu_torch.ops.lie import SE3, quat_from_yaw_pitch_roll, se2_to_se3
    from srba_tpu_torch.solver.multi_window import (make_sweep_step,
                                                    plan_sweep_roots)

    assert port.get_solver is solver.get_solver
    assert callable(make_sweep_step) and callable(plan_sweep_roots)
    assert ECPS["local_areas_var1"] is LocalAreasVar1
    assert {"NoiseConstantMatrix", "KF2KF_POSE_TYPES"} <= set(dir(models))
    assert callable(SE3.from_xyz_ypr) and callable(se2_to_se3) \
        and callable(quat_from_yaw_pitch_roll)
    for name in ("optimize_edges", "refine_map", "optimize_local_area"):
        assert callable(getattr(port.SrbaEngine, name))


SLICE8_MODULES = ["srba_tpu_torch.cli", "srba_tpu_torch.io",
                  "srba_tpu_torch.io.checkpoint",
                  "srba_tpu_torch.io.config_ini",
                  "srba_tpu_torch.io.dataset_io", "srba_tpu_torch.io.g2o",
                  "srba_tpu_torch.io.html_viewer", "srba_tpu_torch.io.render",
                  "srba_tpu_torch.native", "srba_tpu_torch.native.core",
                  "srba_tpu_torch.examples.tutorial_stereo_se3"]


@pytest.mark.parametrize("mod", SLICE8_MODULES)
def test_cli_io_native_modules_import_with_jax_blocked(mod):
    """The CLI, the file I/O, the native core and the tutorials import in
    a fresh interpreter where ``jax`` and ``srba_tpu`` cannot be imported
    at all (``sys.modules[name] = None``), and pull in no matplotlib (the
    renderer imports it at the call)."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'srba_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"importlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                     'srba_tpu', 'matplotlib'))\n"
        "print('LEAKED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


@pytest.mark.parametrize("what", ["engine_mesh", "solver_axis_name",
                                  "sweep_step_mesh", "refine_map_mesh",
                                  "optimize_global_mesh", "pgo_spmd"])
def test_only_mesh_paths_raise(what):
    """The mesh and multi-process execution (the JAX package's
    ``parallel/``) was the last of the port; no entry point raises
    ``NotImplementedError`` any more.  Each mesh entry point runs on a
    one-rank gloo mesh and gives bitwise its unsharded result (the solver
    and the sweep step are held whole in tests/test_torch_sharding.py and
    tests/test_torch_refine_map.py)."""
    import torch.distributed as dist

    from srba_tpu_torch import Observation, SrbaEngine
    from srba_tpu_torch.solver.global_graphslam import (
        PGOConfig, make_pgo_spmd, optimize_global_pose_graph)
    from srba_tpu_torch.solver.lm import SolverConfig, make_solver_impl
    from srba_tpu_torch.solver.multi_window import make_sweep_step_mesh
    from tests.test_torch_sharding import CountAllReduce, one_rank_mesh

    mesh = one_rank_mesh()
    cfg = SolverConfig(obs_model="RangeBearing2D", pose_group="SE2",
                       lm_type="Euclidean2D", max_depth=3)
    odo = np.asarray([0.5, 0.0, 0.2], np.float32)

    def drive(eng, run_local=True):
        for k in range(5):
            eng.define_new_keyframe(
                [Observation(lm_id=j, z=np.asarray(
                    [1.0 + 0.1 * j, 0.2 * j - 0.3 * k], np.float32))
                 for j in range(4)],
                edge_init={k - 1: odo} if k else None,
                run_local_optimization=run_local)
        return eng

    if what == "engine_mesh":
        a = drive(SrbaEngine("RangeBearing2D", mesh=mesh, device="cpu"))
        b = drive(SrbaEngine("RangeBearing2D", device_master=False,
                             device="cpu"))
        assert a.device_master is None
        np.testing.assert_array_equal(a.state.k2k_pose, b.state.k2k_pose)
        np.testing.assert_array_equal(a.state.lm_state, b.state.lm_state)
    elif what == "solver_axis_name":
        # The world's group stands for the mesh: 2 rounds per LM iteration
        # plus err_init and num_obs.
        solve, _ = make_solver_impl(dataclasses.replace(cfg,
                                                        axis_name="obs"))
        eng = drive(SrbaEngine("RangeBearing2D", device_master=False,
                               device="cpu"), run_local=False)
        from srba_tpu_torch.solver.window import build_window
        arrays, _ = build_window(eng.state, eng.graph, 4, 3, 3)
        from srba_tpu_torch.solver.lm import WindowBatch
        batch = WindowBatch(
            **{f: torch.as_tensor(np.asarray(getattr(arrays, f)))
               for f in ("edge_pose", "edge_opt", "lm_state", "lm_opt",
                         "obs_z", "obs_lm", "path_edge", "path_sign",
                         "obs_valid")},
            whitener=torch.eye(2), sensor_pose_inv=torch.zeros(3))
        with CountAllReduce(dist) as count:
            e, l, info = solve(batch)
        e1, l1, info1 = make_solver_impl(cfg)[0](batch)
        assert torch.equal(e, e1) and torch.equal(l, l1)
        assert count.calls == 2 * cfg.max_iters + 2
    elif what in ("sweep_step_mesh", "refine_map_mesh"):
        a = drive(SrbaEngine("RangeBearing2D", device="cpu"), False)
        b = drive(SrbaEngine("RangeBearing2D", device="cpu"), False)
        assert callable(make_sweep_step_mesh(a._solver_cfg, mesh))
        ia = a.refine_map(stride=2, mesh=mesh)
        ib = b.refine_map(stride=2)
        assert ia == ib and ia["windows"] > 0
        assert torch.equal(a.device_master.pose, b.device_master.pose)
        assert torch.equal(a.device_master.lm, b.device_master.lm)
    elif what == "optimize_global_mesh":
        eng = drive(SrbaEngine("RangeBearing2D", device="cpu"))
        G, info = eng.optimize_global(write_back=False)
        G_m, info_m = eng.optimize_global(write_back=False, mesh=mesh)
        np.testing.assert_array_equal(G_m, G)
        assert info_m == info
    else:
        from tests.test_global_pgo import _circle_problem
        prob, _ = _circle_problem("SE2", K=20)
        G, info = optimize_global_pose_graph(prob, PGOConfig("SE2"),
                                             device="cpu")
        G_m, info_m = optimize_global_pose_graph(prob, PGOConfig("SE2"),
                                                 mesh=mesh, device="cpu")
        assert callable(make_pgo_spmd(PGOConfig("SE2"), mesh))
        np.testing.assert_array_equal(G_m, G)
        assert info_m == info
