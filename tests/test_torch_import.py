"""srba_tpu_torch imports no JAX, runs only where it is told to, and names
what it has not ported yet."""

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
            SrbaEngine("MonocularCamera", device="cpu")
        elif what == "group":
            # Both of the JAX package's groups are ported: a name neither
            # package has still raises by name through the lookup.
            make_solver_impl(SolverConfig(**{**base, "pose_group": "Sim3"}))
        elif what == "landmark":
            make_solver_impl(SolverConfig(**{**base,
                                             "lm_type": "InverseDepth"}))
        elif what == "solver":
            make_solver_impl(SolverConfig(
                **{**base, "solver": "no_schur_dense_cholesky"}))
        elif what == "neq":
            make_solver_impl(SolverConfig(**{**base, "neq": "segmented"}))
        else:
            SrbaEngine("RangeBearing2D", device_master=False, device="cpu")
    assert "not ported" in str(ei.value)


def test_unported_models_and_options_raise():
    """The monocular and RGB-D camera models and their calibration are not
    ported: each raises by name."""
    from srba_tpu_torch import SrbaEngine
    from srba_tpu_torch.utils.datasets import make_world_loop_3d, observe

    for name in ("MonocularCamera", "RGBDCamera"):
        with pytest.raises(NotImplementedError, match=name):
            SrbaEngine(name, device="cpu")
    with pytest.raises(NotImplementedError, match="MonocularCamera"):
        observe(make_world_loop_3d(num_kfs=4, num_landmarks=5),
                "MonocularCamera")
    with pytest.raises(NotImplementedError, match="calibrated"):
        SrbaEngine("RangeBearing3D", calib=object(), device="cpu")


def test_closure_targets_raise():
    """Closure targets are served (a policy's closure target with too few
    voters for a fit gets an estimate-seeded edge, as in the JAX package);
    what still raises is the monocular closure fit, by name."""
    from srba_tpu_torch import Observation, SrbaEngine
    from srba_tpu_torch.engine.closure import bootstrap_closure_edge

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

    class Mono:
        name = "MonocularCamera"
        is_pose_landmark = False
        has_inverse_model = False

    eng.model = Mono
    with pytest.raises(NotImplementedError, match="_mono_pnp"):
        bootstrap_closure_edge(eng, 0, [], None)


@pytest.mark.parametrize("mod", ["srba_tpu_torch.engine.closure",
                                 "srba_tpu_torch.ecps",
                                 "srba_tpu_torch.models.observations",
                                 "srba_tpu_torch.models.sensor_pose",
                                 "srba_tpu_torch.utils.datasets"])
def test_closure_and_camera_modules_import_without_jax(mod):
    """Each module config #3 added to or grew in the port, alone in a fresh
    interpreter, pulls in no jax, jaxlib, flax or srba_tpu module."""
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
    """The edge-sharded global PGO is not ported: the engine's
    ``optimize_global(mesh=...)`` raises by name, before any solve."""
    from srba_tpu_torch import SrbaEngine

    eng = SrbaEngine("RelativePoses2D", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        eng.optimize_global(mesh=object())
