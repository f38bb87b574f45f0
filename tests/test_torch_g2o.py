"""The port's g2o importer (srba_tpu_torch.io.g2o): the twins of
tests/test_g2o.py through the port, and the importer's arrays against the
JAX package's on the same files.

Tolerances: ``load_g2o``'s nodes, edges, weights and information shapes
bitwise equal to the JAX importer's (both are the same numpy code); the
round trip and the sphere solve keep tests/test_g2o.py's bounds (atol 1e-6
/ rtol 1e-5 on the re-read graph, weights rtol 1e-2 after the median
normalization, final ATE < 0.2 m and < a tenth of the initial one).
"""

import numpy as np
import pytest
import torch

import srba_tpu_torch as T
from srba_tpu.io.g2o import load_g2o as jax_load_g2o
from srba_tpu_torch.io.export import (get_global_graphslam_problem,
                                      save_graphslam_g2o)
from srba_tpu_torch.io.g2o import load_g2o
from srba_tpu_torch.solver.global_graphslam import (PGOConfig,
                                                    optimize_global_pose_graph)
from srba_tpu_torch.utils.datasets import (ate_rmse, make_world_loop_2d,
                                           observe)
from tests.test_g2o import _write_sphere_g2o

torch.set_num_threads(1)


def _small_engine():
    world = make_world_loop_2d(num_kfs=15, radius=5.0, num_landmarks=60,
                               seed=2)
    ds = observe(world, "RangeBearing2D", noise_std=0.005, sensor_range=5.0,
                 odo_noise_std=0.01, seed=2)
    eng = T.SrbaEngine("RangeBearing2D",
                       params=T.SrbaParams(max_tree_depth=3,
                                           max_optimize_depth=3),
                       device="cpu")
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k else None)
    return eng


def _assert_problems_equal(a, b):
    assert a["group"] == b["group"]
    assert a["reachable"] == b["reachable"]
    np.testing.assert_array_equal(a["nodes"], b["nodes"])
    assert a["nodes"].dtype == b["nodes"].dtype
    np.testing.assert_array_equal(a["edge_weights"], b["edge_weights"])
    assert len(a["edges"]) == len(b["edges"])
    for ea, eb in zip(a["edges"], b["edges"]):
        assert (ea["from"], ea["to"]) == (eb["from"], eb["to"])
        np.testing.assert_array_equal(ea["rel_pose"], eb["rel_pose"])
    assert ("edge_info_sqrt" in a) == ("edge_info_sqrt" in b)
    if "edge_info_sqrt" in a:
        np.testing.assert_array_equal(a["edge_info_sqrt"],
                                      b["edge_info_sqrt"])


def test_se2_roundtrip(tmp_path):
    eng = _small_engine()
    path = str(tmp_path / "graph.g2o")
    save_graphslam_g2o(eng, path)
    prob0 = get_global_graphslam_problem(eng)
    prob1 = load_g2o(path)
    assert prob1["group"] == "SE2"
    np.testing.assert_allclose(prob1["nodes"], prob0["nodes"],
                               atol=1e-6, rtol=1e-5)
    assert len(prob1["edges"]) == len(prob0["edges"])
    for e0, e1 in zip(prob0["edges"], prob1["edges"]):
        assert (e0["from"], e0["to"]) == (e1["from"], e1["to"])
        np.testing.assert_allclose(e1["rel_pose"], e0["rel_pose"],
                                   atol=1e-6, rtol=1e-5)
    w0 = prob0["edge_weights"]
    w1 = prob1["edge_weights"]
    np.testing.assert_allclose(w1, w0 / np.median(w0), rtol=1e-2)
    for info in (False, True):
        _assert_problems_equal(load_g2o(path, with_edge_info=info),
                               jax_load_g2o(path, with_edge_info=info))


def test_sphere_benchmark(tmp_path):
    """The sphere-style SE(3) problem with heavily noised initial nodes,
    imported (bitwise JAX's import) and solved by the port's PGO."""
    path = str(tmp_path / "sphere.g2o")
    gt = _write_sphere_g2o(path)
    prob = load_g2o(path)
    _assert_problems_equal(prob, jax_load_g2o(path))
    assert prob["group"] == "SE3" and len(prob["nodes"]) == 400
    init_ate = float(ate_rmse(prob["nodes"][:, :3], gt[:, :3]))
    G, info = optimize_global_pose_graph(
        prob, PGOConfig(group="SE3", chordal_init=True, max_outer=30,
                        cg_iters=100), device="cpu")
    final_ate = float(ate_rmse(G[:, :3], gt[:, :3]))
    assert info["err_final"] < info["err_init"]
    assert final_ate < 0.1 * init_ate, (init_ate, final_ate)
    assert final_ate < 0.2, final_ate


def test_anisotropic_info_import(tmp_path):
    p = str(tmp_path / "aniso.g2o")
    lines = [
        "VERTEX_SE2 0 0 0 0",
        "VERTEX_SE2 1 1 0 0",
        "VERTEX_SE2 2 2 0 0",
        "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1",
        "EDGE_SE2 1 2 1 0 0 0.01 0 0 100 0 1",
    ]
    open(p, "w").write("\n".join(lines) + "\n")
    prob = load_g2o(p, with_edge_info=True)
    _assert_problems_equal(prob, jax_load_g2o(p, with_edge_info=True))
    S = prob["edge_info_sqrt"]
    assert S.shape == (2, 3, 3)
    np.testing.assert_allclose(S[0], np.eye(3), atol=1e-6)
    assert S[1][1, 1] == pytest.approx(1.0, abs=1e-5)
    assert S[1][0, 0] == pytest.approx(np.sqrt(0.05), abs=1e-5)
    G, info = optimize_global_pose_graph(prob, PGOConfig(group="SE2"),
                                         device="cpu")
    assert np.isfinite(info["err_final"])


@pytest.mark.parametrize("text, match", [
    ("FIX 0\n# comment only\n", "no g2o"),
    ("VERTEX_SE2 0 0 0 0\nVERTEX_SE3:QUAT 1 0 0 0 0 0 0 1\n", "mixed"),
    ("VERTEX_SE2 0 0 0 0\nEDGE_SE2 0 3 1 0 0 1 0 0 1 0 1\n", "missing"),
])
def test_rejects_garbage(tmp_path, text, match):
    """Files the JAX importer refuses, the port refuses with its message."""
    p = tmp_path / "bad.g2o"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        load_g2o(str(p))
    with pytest.raises(ValueError, match=match):
        jax_load_g2o(str(p))


def test_cli_pgo_g2o_matches_jax_cli(tmp_path, capsys):
    """``--pgo-g2o`` through both packages' CLIs on bench.py's ``bench_pgo``
    ring cut to 2000 poses (written as ``chip_smoke.py`` writes the 20000):
    the same iterations and certification, and ``err_final`` at rel 1e-3
    (the whole-solve tolerance of tests/test_torch_global_pgo.py).  With
    the CLI's settings (chordal init, CG 50, ``abs_tol_per_edge`` 5e-6,
    below this problem's noise floor) neither certifies in its 60 LM
    iterations."""
    import json

    from chip_smoke import pgo20k_problem, write_pgo_g2o
    from srba_tpu.cli import main as jax_cli_main
    from srba_tpu_torch.cli import main as cli_main

    path = str(tmp_path / "ring.g2o")
    write_pgo_g2o(pgo20k_problem(2000), path)
    summaries = []
    for main, extra in ((cli_main, ["--device", "cpu"]), (jax_cli_main, [])):
        assert main(["--pgo-g2o", path, "--json", *extra]) == 0
        summaries.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    t, j = summaries
    assert (t["nodes"], t["edges"], t["iters"], t["converged"]) \
        == (j["nodes"], j["edges"], j["iters"], j["converged"])
    assert t["err_final"] == pytest.approx(j["err_final"], rel=1e-3)
    assert t["err_final"] < t["err_init"]
