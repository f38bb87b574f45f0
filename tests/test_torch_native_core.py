"""The port's C++ host graph service (srba_tpu_torch.native) against the
port's Python spanning tree and window builder and against the JAX
package's ``NativeCore``, on the randomized append-only problem histories of
tests/test_native_core.py; and the port's engine building its device-master
windows with it.

Tolerances: none — paths, BFS trees and whole windows, padding and
bucket shapes included, are compared bitwise with the Python builder given
the same ``min_shape`` and with the JAX package's native core (the same
C++ source) given the same ratchet.  The engine's 20-keyframe run: its
bucket sequence equals the JAX engine's exactly, and the Python builder
(no g++) pads like native and ends at the same masters bitwise.
"""

import numpy as np
import pytest
import torch

import srba_tpu as J
import srba_tpu_torch as T
from srba_tpu.engine.state import ProblemState as JState
from srba_tpu.native import get_lib as jax_get_lib
from srba_tpu.native.core import NativeCore as JNativeCore
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.engine.state import ProblemState
from srba_tpu_torch.graph.spantree import KeyframeGraph
from srba_tpu_torch.native import get_lib
from srba_tpu_torch.native.core import NativeCore
from srba_tpu_torch.solver.window import build_window
from srba_tpu_torch.utils import datasets as tds

torch.set_num_threads(1)


def _random_problem(seed, num_kfs=40, tree_depth=4):
    """tests/test_native_core.py's random SRBA-shaped problem, grown into
    the port's state, graph and native core and into a JAX state and JAX
    native core from the same draws."""
    rng = np.random.default_rng(seed)
    st = ProblemState(pose_dim=3, lm_dim=2, z_dim=2)
    jst = JState(pose_dim=3, lm_dim=2, z_dim=2)
    g = KeyframeGraph(tree_depth)
    nc = NativeCore(tree_depth)
    jnc = JNativeCore(tree_depth)
    num_lms = 0

    def edge(a, b):
        pose = rng.normal(size=3).astype(np.float32)
        st.add_edge(a, b, pose)
        jst.add_edge(a, b, pose)
        g.add_edge(a, b)
        nc.add_edge(a, b)
        jnc.add_edge(a, b)

    for k in range(num_kfs):
        st.add_keyframe()
        jst.add_keyframe()
        g.add_keyframe()
        nc.add_keyframe()
        jnc.add_keyframe()
        if k > 0:
            edge(k, k - 1)
        if k > 5 and rng.random() < 0.25:  # occasional loop closure
            edge(k, int(rng.integers(0, k - 3)))
        for _ in range(int(rng.integers(1, 4))):
            fixed = bool(rng.random() < 0.15)
            p = rng.normal(size=2).astype(np.float32)
            st.add_landmark(k, p, fixed=fixed)
            jst.add_landmark(k, p, fixed=fixed)
            nc.add_landmark(k, fixed)
            jnc.add_landmark(k, fixed)
            num_lms += 1
        for _ in range(int(rng.integers(2, 8))):
            lm = int(rng.integers(0, num_lms))
            z = rng.normal(size=2).astype(np.float32)
            st.add_observation(k, lm, z)
            jst.add_observation(k, lm, z)
            nc.add_observation(k, lm)
            jnc.add_observation(k, lm)
    return st, jst, g, nc, jnc


def test_library_builds_here():
    """g++ exists on this machine, so the port builds its native core (the
    Python builder is only for machines without one)."""
    import srba_tpu_torch.native as native
    assert get_lib() is not None
    info = native.build_info
    assert info["so"].endswith(f"libsrba_graph_{info['digest']}.so")
    assert "/build/native/" in info["so"] and "-O3" in info["cmd"]
    assert info["digest"] == native.source_digest()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_path_parity(seed):
    st, _, g, nc, jnc = _random_problem(seed)
    rng = np.random.default_rng(seed + 100)
    for _ in range(200):
        a, b = (int(x) for x in rng.integers(0, st.num_kfs, size=2))
        assert nc.path(a, b) == g.path(a, b, 4) == jnc.path(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_bfs_tree_parity(seed):
    """``NativeCore.bfs_tree`` returns the Python graph's tree: the same
    distances, parents and visit order."""
    st, _, g, nc, _ = _random_problem(seed)
    for root in range(0, st.num_kfs, 3):
        for depth in (None, 2):
            d_n, p_n = nc.bfs_tree(root, depth)
            d_p, p_p = g.bfs_tree(root, depth)
            assert list(d_n.items()) == list(d_p.items())
            assert p_n == p_p


def _assert_windows_equal(nat, ref):
    na, np_ = nat
    ra, rp = ref
    assert np_.num_obs == rp.num_obs
    assert np_.shape_key == rp.shape_key
    for f in ("edge_ids", "edge_opt", "lm_ids", "lm_opt"):
        np.testing.assert_array_equal(getattr(np_, f), getattr(rp, f))
    for f in ("edge_opt", "lm_opt", "obs_z", "obs_lm", "path_edge",
              "path_sign", "obs_valid", "edge_gids", "lm_gids"):
        a, b = getattr(na, f), getattr(ra, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cap", [None, 2])
def test_window_parity(seed, cap):
    """Whole windows bitwise: the port's native core and Python builder
    from the shape the JAX native core's ratchet reached."""
    st, jst, g, nc, jnc = _random_problem(seed)
    rng = np.random.default_rng(seed + 200)
    roots = list(rng.integers(1, st.num_kfs, size=12)) + [st.num_kfs - 1]
    caps = None
    for root in (int(r) for r in roots):
        py = build_window(st, g, root, 3, 4, extra_obs_per_lm_cap=cap,
                          gather_floats=False, min_shape=caps)
        nat = nc.build_window(st, root, 3, 4, obs_per_lm_cap=cap,
                              min_shape=caps)
        jnat = jnc.build_window(jst, root, 3, 4, obs_per_lm_cap=cap)
        assert (py is None) == (nat is None) == (jnat is None), root
        if py is None:
            continue
        _assert_windows_equal(nat, py)
        _assert_windows_equal(nat, jnat)
        caps = nat[1].shape_key


def test_ratchet_never_shrinks():
    """A small window built from a large window's shape keeps that shape in
    both builders; the engine's shapes per optimize depth never shrink
    across a run, and without a floor each builder pads to the ladder."""
    st, _, g, nc, _ = _random_problem(0)
    plans = {r: build_window(st, g, r, 3, 4, gather_floats=False)[1]
             for r in range(1, st.num_kfs)}
    r_big = max(plans, key=lambda r: plans[r].num_obs)
    r_small = min(plans, key=lambda r: plans[r].num_obs)
    big = plans[r_big].shape_key
    assert plans[r_small].shape_key != big
    assert nc.build_window(st, r_small, 3, 4)[1].shape_key == \
        plans[r_small].shape_key
    _, small = nc.build_window(st, r_small, 3, 4, min_shape=big)
    _, small_py = build_window(st, g, r_small, 3, 4, gather_floats=False,
                               min_shape=big)
    assert small.num_obs < plans[r_big].num_obs
    assert small.shape_key == small_py.shape_key == big

    _, ds = _loop20()
    eng = T.SrbaEngine(
        "RangeBearing2D", device="cpu",
        params=T.SrbaParams(max_tree_depth=4, max_optimize_depth=4))
    seen = []
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
        if 4 in eng._window_caps:
            seen.append(eng._window_caps[4])
    assert len(seen) == 19 and len(set(seen)) > 1
    assert all(all(a <= b for a, b in zip(s0, s1))
               for s0, s1 in zip(seen, seen[1:]))


def test_depth_limit_and_bad_mutations_raise():
    """The C++ core's limits fail by name (not by ``assert``): a tree deeper
    than its path-step buffers, an edge or observation it cannot hold; an
    engine that deep builds with the Python builder."""
    from srba_tpu_torch.native.core import MAX_TREE_DEPTH
    with pytest.raises(ValueError, match="max_tree_depth <= 64"):
        NativeCore(MAX_TREE_DEPTH + 1)
    nc = NativeCore(MAX_TREE_DEPTH)
    nc.add_keyframe()
    with pytest.raises(RuntimeError, match="bad edge"):
        nc.add_edge(0, 1)
    with pytest.raises(RuntimeError, match="bad observation"):
        nc.add_observation(0, 0)
    eng = T.SrbaEngine(
        "RangeBearing2D", device="cpu",
        params=T.SrbaParams(max_tree_depth=MAX_TREE_DEPTH + 1))
    assert eng.native is None and eng.device_master is not None


def _loop20():
    kw = dict(num_kfs=20, radius=8.0, num_landmarks=50, seed=9)
    okw = dict(noise_std=0.005, sensor_range=6.0, odo_noise_std=0.01,
               seed=9)
    wj = jds.make_world_loop_2d(**kw)
    wt = tds.make_world_loop_2d(**kw)
    return (jds.observe(wj, "RangeBearing2D", **okw),
            tds.observe(wt, "RangeBearing2D", **okw))


def _drive(pkg, ds, monkeypatch, python_windows=False, **kw):
    """A 20-keyframe config #1-style run; returns the engine, the bucket
    shape of every window it built and the number of native builds."""
    shapes, native = [], []
    core_cls = NativeCore if pkg is T else JNativeCore
    build = core_cls.build_window

    def native_build(self, *a, **k):
        out = build(self, *a, **k)
        native.append(out)
        if pkg is J and out is not None:
            shapes.append(out[1].shape_key)
        return out

    monkeypatch.setattr(core_cls, "build_window", native_build)
    if pkg is T:
        engine_build = T.SrbaEngine._build_window

        def recorder(self, *a, **k):
            out = engine_build(self, *a, **k)
            if out is not None:
                shapes.append(out[1].shape_key)
            return out

        monkeypatch.setattr(T.SrbaEngine, "_build_window", recorder)
    eng = pkg.SrbaEngine(
        "RangeBearing2D",
        params=pkg.SrbaParams(max_tree_depth=4, max_optimize_depth=4), **kw)
    if python_windows:
        eng.native = None
    else:
        assert isinstance(eng.native, core_cls)
    for k, frame in enumerate(ds.frames):
        obs = [pkg.Observation(lm_id=m, z=z) for m, z in frame]
        eng.define_new_keyframe(
            obs, edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)
    monkeypatch.setattr(core_cls, "build_window", build)
    if pkg is T:
        monkeypatch.setattr(T.SrbaEngine, "_build_window", engine_build)
    return eng, shapes, len(native)


@pytest.mark.skipif(jax_get_lib() is None,
                    reason="the JAX package's native library is unavailable")
def test_engine_uses_native_and_matches_jax_buckets(monkeypatch):
    """The port's device-master engine builds every window natively, ends
    where the Python builder does, and pads its windows to the JAX engine's
    bucket sequence."""
    dsj, dst = _loop20()
    eng_n, shapes_t, n_native = _drive(T, dst, monkeypatch, device="cpu")
    eng_p, shapes_p, none = _drive(T, dst, monkeypatch,
                                   python_windows=True, device="cpu")
    _, shapes_j, _ = _drive(J, dsj, monkeypatch)
    assert len(shapes_t) == n_native == 19 and none == 0
    assert shapes_t == shapes_j
    assert eng_n.eval_overall_squared_error() == pytest.approx(
        eng_p.eval_overall_squared_error(), rel=1e-3, abs=1e-8)


def test_python_builder_pads_like_native(monkeypatch):
    """The padded shapes are the engine's, not the builder's: without the
    native core (no g++, or the opt-out) the device-master engine emits the
    same bucket sequence and ends at the same masters bitwise."""
    _, ds = _loop20()
    eng_n, shapes_n, _ = _drive(T, ds, monkeypatch, device="cpu")
    eng_p, shapes_p, _ = _drive(T, ds, monkeypatch, python_windows=True,
                                device="cpu")
    assert shapes_p == shapes_n and len(set(shapes_n)) > 1
    for a, b in ((eng_n.device_master.pose, eng_p.device_master.pose),
                 (eng_n.device_master.lm, eng_p.device_master.lm)):
        assert torch.equal(a, b)


def test_host_window_mode_keeps_python_builder():
    eng = T.SrbaEngine("RangeBearing2D", device_master=False, device="cpu")
    assert eng.native is None


def test_opt_out_variable(monkeypatch):
    monkeypatch.setenv("SRBA_TPU_TORCH_NO_NATIVE", "1")
    assert get_lib() is None
    assert T.SrbaEngine("RangeBearing2D", device="cpu").native is None


def test_no_compiler_falls_back_with_one_line(monkeypatch, capsys):
    """Without g++ the library is not built, the engine keeps the Python
    builder, and stderr says so once."""
    import shutil

    import srba_tpu_torch.native as native
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert get_lib() is None
    assert get_lib() is None
    assert T.SrbaEngine("RangeBearing2D", device="cpu").native is None
    err = capsys.readouterr().err
    assert err.count("no g++ found") == 1


def test_checkpoint_replays_native(tmp_path):
    """A loaded engine's native core holds the checkpoint's graph: its
    windows equal the saved engine's (real part) and its next keyframes
    match the uninterrupted run."""
    from srba_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    _, ds = _loop20()

    def feed(eng, lo, hi):
        for k in range(lo, hi):
            eng.define_new_keyframe(
                [T.Observation(lm_id=m, z=z) for m, z in ds.frames[k]],
                edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None)

    params = T.SrbaParams(max_tree_depth=3, max_optimize_depth=3)
    eng = T.SrbaEngine("RangeBearing2D", params=params, device="cpu")
    feed(eng, 0, 12)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(eng, p)
    eng2 = load_checkpoint(p, device="cpu")
    assert eng2.native is not None
    for root in range(1, 12):
        a = eng.native.build_window(eng.state, root, 3, 3)
        b = eng2.native.build_window(eng2.state, root, 3, 3)
        _assert_windows_equal(b, a)
        assert eng2.native.path(0, root) == eng.native.path(0, root)
    feed(eng, 12, 20)
    feed(eng2, 12, 20)
    assert eng2.state.num_edges == eng.state.num_edges
    assert eng2.eval_overall_squared_error() == pytest.approx(
        eng.eval_overall_squared_error(), rel=2e-3)
