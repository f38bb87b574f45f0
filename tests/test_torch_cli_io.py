"""The port's ``srba_slam_torch`` CLI, dataset files and checkpoints: the
twins of tests/test_cli_io.py through the port (on the CPU), and the port
against the JAX package on the same inputs.

Tolerances:
- dataset and ground-truth files byte-identical to the JAX package's (the
  same ``%.9g`` text of bit-identical seeded datasets);
- the CLI's ``--json`` summary from both packages on the same argv: counts
  exact, ``overall_sq_error`` rel 2e-3 and ATE atol 1e-3 (the bounds of
  tests/test_torch_e2e_rb2d.py);
- checkpoints crossing between the packages: tables bitwise equal to the
  saving engine's, the model configuration in the meta JSON equal, then
  the same next keyframes on both sides within the bounds above;
- the twins keep tests/test_cli_io.py's bounds.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.cli import main as jax_cli_main
from srba_tpu.io import checkpoint as jck
from srba_tpu.io import dataset_io as jdio
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.cli import build_parser
from srba_tpu_torch.cli import main as cli_main
from srba_tpu_torch.ecps import LocalAreasFixedGrid, LocalAreasVar1
from srba_tpu_torch.io.checkpoint import (TABLES, load_checkpoint,
                                          save_checkpoint)
from srba_tpu_torch.io.dataset_io import (load_dataset, load_ground_truth,
                                          save_dataset, save_ground_truth)
from srba_tpu_torch.utils import datasets as tds
from srba_tpu_torch.utils.datasets import (ate_rmse, make_world_loop_2d,
                                           observe)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ERR_RTOL, ATE_ATOL = 2e-3, 1e-3
SMALL = ["--max-tree-depth", "3", "--max-optimize-depth", "3"]


def _cli(argv, capsys, main=cli_main, device=True):
    rc = main(argv + (["--device", "cpu"] if device else []))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dataset_roundtrip(tmp_path):
    world = make_world_loop_2d(num_kfs=10, radius=6.0, num_landmarks=30,
                               seed=1)
    ds = observe(world, "RangeBearing2D", noise_std=0.01, sensor_range=5.0,
                 odo_noise_std=0.01, seed=1)
    p = tmp_path / "ds.txt"
    save_dataset(ds, str(p))
    save_ground_truth(world, str(p) + ".gt")
    model, frames, odometry = load_dataset(str(p))
    assert model == "RangeBearing2D"
    assert len(frames) == 10
    for k in range(10):
        assert len(frames[k]) == len(ds.frames[k])
        for (m1, z1), (m2, z2) in zip(frames[k], ds.frames[k]):
            assert m1 == m2
            np.testing.assert_allclose(z1, z2, rtol=1e-6)
    for a, b in zip(odometry, ds.odometry):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    gt = load_ground_truth(str(p) + ".gt")
    np.testing.assert_allclose(gt, world.gt_poses, rtol=1e-6)
    # The JAX package writes the same bytes for the same seeded dataset.
    jworld = jds.make_world_loop_2d(num_kfs=10, radius=6.0,
                                    num_landmarks=30, seed=1)
    jds_ = jds.observe(jworld, "RangeBearing2D", noise_std=0.01,
                       sensor_range=5.0, odo_noise_std=0.01, seed=1)
    q = tmp_path / "jax.txt"
    jdio.save_dataset(jds_, str(q))
    jdio.save_ground_truth(jworld, str(q) + ".gt")
    assert p.read_bytes() == q.read_bytes()
    assert pathlib.Path(str(p) + ".gt").read_bytes() \
        == pathlib.Path(str(q) + ".gt").read_bytes()
    # ... and reads them back alike.
    jm, jf, jo = jdio.load_dataset(str(p))
    assert jm == model and len(jf) == len(frames)
    for fa, fb in zip(frames, jf):
        for (m1, z1), (m2, z2) in zip(fa, fb):
            assert m1 == m2
            np.testing.assert_array_equal(z1, z2)
    np.testing.assert_array_equal(jdio.load_ground_truth(str(p) + ".gt"), gt)


def _run_small(params=None, n=12):
    world = make_world_loop_2d(num_kfs=n, radius=6.0, num_landmarks=40,
                               seed=2)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.01, seed=2)
    eng = T.SrbaEngine("RangeBearing2D", params=params or T.SrbaParams(
        max_tree_depth=3, max_optimize_depth=3), device="cpu")
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    return eng, world, ds


class TestCheckpoint:
    def test_roundtrip_and_resume(self, tmp_path):
        eng, world, ds = _run_small()
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng, p)
        eng2 = load_checkpoint(p, device="cpu")
        st1, st2 = eng.state, eng2.state
        assert st2.num_kfs == st1.num_kfs
        assert st2.num_edges == st1.num_edges
        np.testing.assert_allclose(st2.edge_poses, st1.edge_poses)
        np.testing.assert_allclose(st2.landmark_states, st1.landmark_states)
        assert eng2._lm_id_map == eng._lm_id_map
        frame_obs = [T.Observation(lm_id=m, z=z) for m, z in ds.frames[-1]]
        info = eng2.define_new_keyframe(frame_obs)
        assert info.kf_id == st1.num_kfs
        assert "err_final" in info.optimize_results

    def test_eval_matches_after_reload(self, tmp_path):
        eng, _, _ = _run_small()
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng, p)
        eng2 = load_checkpoint(p, device="cpu")
        assert eng2.eval_overall_squared_error() == pytest.approx(
            eng.eval_overall_squared_error(), rel=1e-5)
        # Saved again, the checkpoint's tables are bitwise the same.
        q = str(tmp_path / "ck2.npz")
        save_checkpoint(eng2, q)
        with np.load(p) as a, np.load(q) as b:
            for t in TABLES:
                np.testing.assert_array_equal(a[t], b[t])
                assert a[t].dtype == b[t].dtype

    def test_configuration_fidelity(self, tmp_path):
        """The meta restores calib / noise / sensor pose / ECP: a resumed
        stereo run does not silently fall back to defaults."""
        from srba_tpu_torch.models.noise import NoiseConstantMatrix
        from srba_tpu_torch.models.observations import StereoCalib
        from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
        from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3
        from srba_tpu_torch.utils.datasets import make_world_loop_3d

        calib = StereoCalib.make(fx=210.0, fy=190.0, cx=155.0, cy=125.0,
                                 baseline=0.14)
        cov = np.diag([0.09, 0.09, 0.16, 0.16])
        eng = T.SrbaEngine(
            "StereoCamera", calib=calib,
            noise=NoiseConstantMatrix(cov),
            sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
            ecp=LocalAreasFixedGrid(submap_size=7,
                                    min_obs_count_loop_closure=5),
            params=T.SrbaParams(max_tree_depth=3, max_optimize_depth=3),
            device="cpu")
        world = make_world_loop_3d(num_kfs=6, radius=6.0, num_landmarks=60,
                                   seed=4)
        ds = observe(world, "StereoCamera", calib=calib, noise_std=0.3,
                     sensor_range=8.0, odo_noise_std=0.01, seed=4)
        for k, frame in enumerate(ds.frames):
            eng.define_new_keyframe(
                [T.Observation(lm_id=m, z=z) for m, z in frame],
                edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng, p)
        eng2 = load_checkpoint(p, device="cpu")  # all from the file
        assert float(eng2.calib.baseline) == pytest.approx(0.14)
        assert float(eng2.calib.fx) == pytest.approx(210.0)
        assert eng2.noise.name == "constant_matrix"
        np.testing.assert_allclose(eng2.noise.cov, cov)
        assert not eng2.sensor_pose.is_identity
        np.testing.assert_allclose(
            np.asarray(eng2.sensor_pose.pose_for(eng2.group)),
            np.asarray(CAMERA_SENSOR_POSE_SE3), rtol=1e-6)
        assert eng2.ecp.name == "local_areas_fixed_grid"
        assert eng2.ecp.submap_size == 7
        assert eng2.ecp.min_obs_count_loop_closure == 5
        np.testing.assert_allclose(eng2._whitener, eng._whitener, rtol=1e-6)
        frame_obs = [T.Observation(lm_id=m, z=z) for m, z in ds.frames[-1]]
        info = eng2.define_new_keyframe(frame_obs)
        assert "err_final" in info.optimize_results

    def test_kill_and_resume_matches_uninterrupted(self, tmp_path):
        world = make_world_loop_2d(num_kfs=20, radius=6.0, num_landmarks=50,
                                   seed=5)
        ds = observe(world, "RangeBearing2D", noise_std=0.005,
                     sensor_range=5.0, odo_noise_std=0.01, seed=5)

        def feed(eng, lo, hi):
            for k in range(lo, hi):
                eng.define_new_keyframe(
                    [T.Observation(lm_id=m, z=z) for m, z in ds.frames[k]],
                    edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)

        params = T.SrbaParams(max_tree_depth=3, max_optimize_depth=3)
        eng_a = T.SrbaEngine("RangeBearing2D", params=params, device="cpu")
        feed(eng_a, 0, 20)
        Ga, _ = eng_a.create_complete_spanning_tree(0)
        ate_a = ate_rmse(Ga[:, :2], world.gt_poses[:, :2])

        eng_b = T.SrbaEngine("RangeBearing2D", params=params, device="cpu")
        feed(eng_b, 0, 10)
        p = str(tmp_path / "ck.npz")
        save_checkpoint(eng_b, p)
        del eng_b                    # "kill"
        eng_c = load_checkpoint(p, device="cpu")
        feed(eng_c, 10, 20)
        Gc, _ = eng_c.create_complete_spanning_tree(0)
        ate_c = ate_rmse(Gc[:, :2], world.gt_poses[:, :2])
        assert ate_c == pytest.approx(ate_a, abs=0.01)
        assert ate_c < 0.15


def _var1_checkpoint(tmp_path):
    eng = T.SrbaEngine("RangeBearing2D", ecp=LocalAreasVar1(3, 4),
                       device="cpu")
    world = make_world_loop_2d(num_kfs=6, radius=6.0, num_landmarks=30,
                               seed=3)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 seed=3)
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    p = str(tmp_path / "var1.npz")
    save_checkpoint(eng, p)
    return eng, ds, p


def _rewrite_meta(src, dst, edit):
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    edit(meta)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(dst, **arrays)


class TestCheckpointRepair:
    def test_v4_var1_asks_for_ecp(self, tmp_path):
        """A pre-v5 ``local_areas_var1`` checkpoint (the legacy
        ``submap_size`` key, no policy state) raises a ValueError that asks
        for ``ecp=``; with ``ecp=`` it loads and resumes."""
        eng, ds, p = _var1_checkpoint(tmp_path)
        v4 = str(tmp_path / "v4.npz")

        def to_v4(meta):
            meta["version"] = 4
            meta["ecp"] = {"name": "local_areas_var1", "submap_size": 10,
                           "min_obs_count_loop_closure": 4,
                           "min_obs_to_join": 3}
        _rewrite_meta(p, v4, to_v4)
        with pytest.raises(ValueError, match="pass ecp="):
            load_checkpoint(v4, device="cpu")
        ecp = LocalAreasVar1(3, 4)
        ecp.set_state(eng.ecp.get_state())
        eng2 = load_checkpoint(v4, ecp=ecp, device="cpu")
        assert eng2.state.num_edges == eng.state.num_edges
        eng2.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in ds.frames[-1]])

    def test_v5_var1_state_and_legacy_keys(self, tmp_path):
        """A v5 var1 checkpoint restores the policy's state; a keyword the
        policy does not have is dropped, not passed on."""
        eng, _, p = _var1_checkpoint(tmp_path)
        eng2 = load_checkpoint(p, device="cpu")
        assert eng2.ecp.get_state() == eng.ecp.get_state()
        extra = str(tmp_path / "extra.npz")
        _rewrite_meta(p, extra,
                      lambda m: m["ecp"].update({"submap_size": 10}))
        assert load_checkpoint(extra, device="cpu").ecp.get_state() \
            == eng.ecp.get_state()


# -- checkpoints crossing between the packages -------------------------------

def _loop15(pkg_ds):
    world = pkg_ds.make_world_loop_2d(num_kfs=16, radius=6.0,
                                      num_landmarks=50, seed=5)
    ds = pkg_ds.observe(world, "RangeBearing2D", noise_std=0.005,
                        sensor_range=5.0, odo_noise_std=0.01, seed=5)
    return world, ds


def _feed(pkg, eng, ds, lo, hi):
    for k in range(lo, hi):
        eng.define_new_keyframe(
            [pkg.Observation(lm_id=m, z=z) for m, z in ds.frames[k]],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)


def _tables_equal(st_a, st_b):
    for t in TABLES:
        n = {"k": st_a.num_edges, "l": st_a.num_lms, "o": st_a.num_obs}[t[0]]
        a, b = getattr(st_a, t)[:n], getattr(st_b, t)[:n]
        np.testing.assert_array_equal(a, b, err_msg=t)
        assert a.dtype == b.dtype, t
    assert (st_a.num_kfs, st_a.num_edges, st_a.num_lms, st_a.num_obs) \
        == (st_b.num_kfs, st_b.num_edges, st_b.num_lms, st_b.num_obs)


def _ate(G, world):
    return float(tds.ate_rmse(np.asarray(G)[:, :2], world.gt_poses[:, :2]))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, saver):
    """A checkpoint saved by one package loads in the other with the tables
    bitwise equal to the saving engine's, and both go on to the same next
    keyframes."""
    wj, dsj = _loop15(jds)
    wt, dst = _loop15(tds)
    params = dict(max_tree_depth=3, max_optimize_depth=3)
    p = str(tmp_path / "ck.npz")
    if saver == "jax":
        src = J.SrbaEngine("RangeBearing2D", params=J.SrbaParams(**params))
        _feed(J, src, dsj, 0, 10)
        jck.save_checkpoint(src, p)
        dst_eng = load_checkpoint(p, device="cpu")
    else:
        src = T.SrbaEngine("RangeBearing2D", params=T.SrbaParams(**params),
                           device="cpu")
        _feed(T, src, dst, 0, 10)
        save_checkpoint(src, p)
        dst_eng = jck.load_checkpoint(p)
    src.sync()
    _tables_equal(src.state, dst_eng.state)
    assert dst_eng._lm_id_map == src._lm_id_map
    jax_eng, port_eng = (src, dst_eng) if saver == "jax" else (dst_eng, src)
    _feed(J, jax_eng, dsj, 10, 16)
    _feed(T, port_eng, dst, 10, 16)
    assert port_eng.state.num_edges == jax_eng.state.num_edges
    assert port_eng.eval_overall_squared_error() == pytest.approx(
        jax_eng.eval_overall_squared_error(), rel=ERR_RTOL)
    Gj, _ = jax_eng.create_complete_spanning_tree(0)
    Gt, _ = port_eng.create_complete_spanning_tree(0)
    assert abs(_ate(Gt, wt) - _ate(Gj, wj)) < ATE_ATOL


def test_checkpoint_meta_matches_jax(tmp_path):
    """The model configuration a checkpoint carries (parameters,
    calibration, noise, mount, policy) is the JSON the JAX package writes
    for the same engine."""
    from srba_tpu.ecps import LocalAreasFixedGrid as JGrid
    from srba_tpu.models.noise import NoiseConstantMatrix as JCov
    from srba_tpu.models.observations import StereoCalib as JStereo
    from srba_tpu.models.sensor_pose import SensorPoseSE3 as JMount
    from srba_tpu_torch.models.noise import NoiseConstantMatrix
    from srba_tpu_torch.models.observations import StereoCalib
    from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
    from srba_tpu_torch.ops.np_lie import CAMERA_SENSOR_POSE_SE3

    cov = np.diag([0.09, 0.09, 0.16, 0.16])
    calib = dict(fx=210.0, fy=190.0, cx=155.0, cy=125.0, baseline=0.14)
    params = dict(max_tree_depth=3, max_optimize_depth=2,
                  extra_obs_per_lm_cap=6)
    eng_t = T.SrbaEngine(
        "StereoCamera", calib=StereoCalib.make(**calib),
        noise=NoiseConstantMatrix(cov),
        sensor_pose=SensorPoseSE3(CAMERA_SENSOR_POSE_SE3),
        ecp=LocalAreasFixedGrid(7, 5), params=T.SrbaParams(**params),
        device="cpu")
    eng_j = J.SrbaEngine(
        "StereoCamera", calib=JStereo.make(**calib), noise=JCov(cov),
        sensor_pose=JMount(CAMERA_SENSOR_POSE_SE3), ecp=JGrid(7, 5),
        params=J.SrbaParams(**params))
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    save_checkpoint(eng_t, pt)
    jck.save_checkpoint(eng_j, pj)
    with np.load(pt) as a, np.load(pj) as b:
        assert bytes(a["meta"]) == bytes(b["meta"])
        assert a.files == b.files


# -- the CLI -----------------------------------------------------------------

class TestCLI:
    def test_synthetic_run_json(self, capsys):
        summary = _cli([
            "--synthetic", "loop2d", "--num-kfs", "12", "--num-landmarks",
            "40", "--noise-std", "0.005", *SMALL, "--json"], capsys)
        assert summary["num_kfs"] == 12
        assert summary["ate_rmse"] < 0.5
        assert summary["kf_per_sec"] > 0

    def test_dataset_file_run_with_exports(self, tmp_path, capsys):
        ds_path = str(tmp_path / "ds.txt")
        _cli(["--synthetic", "loop2d", "--num-kfs", "10", "--num-landmarks",
              "30", "--save-dataset", ds_path, *SMALL, "--json"], capsys)
        dot = str(tmp_path / "g.dot")
        g2o = str(tmp_path / "g.g2o")
        ck = str(tmp_path / "ck.npz")
        summary = _cli([
            "--dataset", ds_path, "--gt-path", ds_path + ".gt", *SMALL,
            "--export-dot", dot, "--export-g2o", g2o,
            "--save-checkpoint", ck, "--json"], capsys)
        assert summary["num_kfs"] == 10
        assert "ate_rmse" in summary
        assert os.path.exists(dot) and os.path.exists(g2o)
        eng = load_checkpoint(ck, device="cpu")
        assert eng.num_keyframes == 10

    def test_export_html_viewer(self, tmp_path, capsys):
        import re
        html = str(tmp_path / "map.html")
        _cli(["--synthetic", "loop2d", "--num-kfs", "12", "--num-landmarks",
              "30", *SMALL, "--export-html", html, "--render-spantree-root",
              "0", "--json"], capsys)
        src = open(html).read()
        assert "<canvas" in src and "const SCENE =" in src
        m = re.search(r"const SCENE = (\{.*?\});\n", src, re.S)
        scene = json.loads(m.group(1))
        assert len(scene["kf_positions"]) == 12
        assert len(scene["landmarks"]) > 0
        assert len(scene["spanning_tree_edges"]) > 0
        assert "http://" not in src and "https://" not in src

    def test_graphslam_synthetic(self, capsys):
        summary = _cli(["--synthetic", "graphslam2d", "--num-kfs", "15",
                        "--odo-noise-std", "0.03", *SMALL, "--json"], capsys)
        assert summary["ate_rmse"] < 0.3

    def test_missing_input_errors(self, capsys):
        assert cli_main(["--json", "--device", "cpu"]) == 2

    def test_metrics_jsonl_and_render(self, tmp_path, capsys):
        mj = str(tmp_path / "metrics.jsonl")
        png = str(tmp_path / "map.png")
        _cli(["--synthetic", "loop2d", "--num-kfs", "10", "--num-landmarks",
              "30", *SMALL, "--metrics-jsonl", mj, "--render", png,
              "--render-spantree-root", "0", "--json"], capsys)
        rows = [json.loads(ln) for ln in open(mj)]
        assert len(rows) == 10
        assert rows[3]["kf"] == 3 and rows[3]["wall_ms"] > 0
        assert "err_final" in rows[3] and "iters" in rows[3]
        assert os.path.getsize(png) > 10000

    def test_rgbd_cli_run(self, capsys):
        summary = _cli([
            "--synthetic", "loop3d", "--obs", "RGBDCamera",
            "--sensor-pose-camera", "--num-kfs", "10", "--num-landmarks",
            "120", "--noise-std", "0.05", *SMALL, "--json"], capsys)
        assert summary["ate_rmse"] < 0.3

    def test_autosave_preemption_resume(self, tmp_path, capsys):
        """Autosave every 3 KFs in a fresh process leaves a resumable
        checkpoint, and the CLI resumes from it."""
        ck = str(tmp_path / "auto.npz")
        rc = subprocess.run(
            [sys.executable, "-m", "srba_tpu_torch.cli", "--synthetic",
             "loop2d", "--num-kfs", "9", "--num-landmarks", "30", *SMALL,
             "--autosave-checkpoint", ck, "--autosave-every", "3", "--json",
             "--device", "cpu"],
            cwd=REPO, capture_output=True, timeout=300)
        assert rc.returncode == 0, rc.stderr[-800:]
        eng = load_checkpoint(ck, device="cpu")
        assert 3 <= eng.num_keyframes <= 9
        _cli(["--synthetic", "loop2d", "--num-kfs", "9", "--num-landmarks",
              "30", *SMALL, "--resume-checkpoint", ck, "--json"], capsys)

    def test_subprocess_entry(self):
        """``python -m srba_tpu_torch.cli`` in a fresh process."""
        out = subprocess.run(
            [sys.executable, "-m", "srba_tpu_torch.cli", "--synthetic",
             "loop2d", "--num-kfs", "8", "--num-landmarks", "25", *SMALL,
             "--json", "--device", "cpu"],
            capture_output=True, text=True, cwd=REPO, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        assert summary["num_kfs"] == 8


def test_sigterm_saves_and_exits_without_jax(tmp_path):
    """With ``jax`` blocked from importing: a SIGTERM at keyframe 4 makes
    the CLI save its autosave checkpoint and exit 0, and the checkpoint
    resumes at keyframe 5."""
    ck = str(tmp_path / "sig.npz")
    code = (
        "import os, runpy, signal, sys\n"
        "for m in ('jax', 'jaxlib', 'srba_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from srba_tpu_torch.engine.engine import SrbaEngine\n"
        "step = SrbaEngine.define_new_keyframe\n"
        "def kill_at_4(self, *a, **k):\n"
        "    out = step(self, *a, **k)\n"
        "    if out.kf_id == 4:\n"
        "        os.kill(os.getpid(), signal.SIGTERM)\n"
        "    return out\n"
        "SrbaEngine.define_new_keyframe = kill_at_4\n"
        "sys.argv = ['srba_slam_torch'] + sys.argv[1:]\n"
        "runpy.run_module('srba_tpu_torch.cli', run_name='__main__')\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "--synthetic", "loop2d", "--num-kfs",
         "12", "--num-landmarks", "30", *SMALL, "--autosave-checkpoint", ck,
         "--autosave-every", "100", "--json", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"preempted at kf 4: checkpoint saved to {ck}" in out.stderr
    assert out.stdout.strip() == ""          # no summary: it stopped early
    assert load_checkpoint(ck, device="cpu").num_keyframes == 5


def test_cli_defaults_to_cuda(monkeypatch):
    """``--device`` defaults to cuda and raises where there is none;
    ``--jax-cache`` is not a flag of the port."""
    args = build_parser().parse_args(["--synthetic", "loop2d"])
    assert args.device == "cuda"
    assert not hasattr(args, "jax_cache")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--synthetic", "loop2d", "--num-kfs", "3", "--json"])


def test_cli_flags_match_jax():
    """Every flag of the JAX runner but --jax-cache, and --device."""
    from srba_tpu.cli import build_parser as jax_build_parser

    def flags(p):
        return {s for a in p._actions for s in a.option_strings}
    assert flags(build_parser()) == \
        (flags(jax_build_parser()) - {"--jax-cache"}) | {"--device"}


@pytest.mark.parametrize("argv", [
    ["--synthetic", "loop2d", "--num-kfs", "12", "--num-landmarks", "40",
     "--noise-std", "0.005", *SMALL],
    ["--synthetic", "graphslam2d", "--num-kfs", "15", "--odo-noise-std",
     "0.03", *SMALL],
    ["--synthetic", "loop3d", "--num-kfs", "10", "--num-landmarks", "120",
     *SMALL, "--ecp", "local_areas_fixed_grid", "--submap-size", "4"],
], ids=["loop2d", "graphslam2d", "loop3d_local_areas"])
def test_cli_matches_jax(argv, capsys):
    """The same argv through both runners: the same counts, the error at
    rel 2e-3 and the ATE at atol 1e-3."""
    t = _cli(argv + ["--json"], capsys)
    j = _cli(argv + ["--json"], capsys, main=jax_cli_main, device=False)
    assert set(t) == set(j)
    for k in ("num_kfs", "num_landmarks", "num_edges", "num_obs"):
        assert t[k] == j[k], k
    assert t["overall_sq_error"] == pytest.approx(j["overall_sq_error"],
                                                  rel=ERR_RTOL)
    assert abs(t["ate_rmse"] - j["ate_rmse"]) < ATE_ATOL


def test_cli_pgo_g2o_mode(tmp_path, capsys):
    """Standalone pose-graph mode: g2o in -> PGO -> optimized g2o out."""
    from srba_tpu_torch.io.g2o import load_g2o
    from tests.test_g2o import _write_sphere_g2o

    src = str(tmp_path / "sphere.g2o")
    out = str(tmp_path / "opt.g2o")
    gt = _write_sphere_g2o(src, n_ring=20, n_rings=6)
    summary = _cli(["--pgo-g2o", src, "--export-g2o", out, "--json"], capsys)
    assert summary["converged"] == 1
    assert summary["err_final"] < summary["err_init"]
    opt = load_g2o(out)
    ate = float(ate_rmse(opt["nodes"][:, :3], gt[:, :3]))
    assert ate < 0.2, ate
