"""The port's profiler scopes as spans of a ``torch.profiler`` trace, on the
CPU: ``Profiler.scope`` and ``span`` emit ``srba.<key>`` only while a trace
records (outside one they never reach ``record_function``); what they
record under a trace is tallied in ``TRACED``; the PGO's scopes wait for
the device only without a trace; and ``refine_map``'s scopes, spans and
counters on the 30-keyframe map of tests/test_refine_map.py, whose sweep
comes out bitwise the same with a trace on and off."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import srba_tpu_torch as T
from srba_tpu_torch.engine.engine import SrbaEngine
from srba_tpu_torch.models.noise import NoiseIdentity
from srba_tpu_torch.solver import global_graphslam as gg
from srba_tpu_torch.solver import multi_window as mw
from srba_tpu_torch.utils import datasets as tds
from srba_tpu_torch.utils import profiler as pm
from srba_tpu_torch.utils.profiler import TRACED, Profiler, span

torch.set_num_threads(1)

SWEEPS, STRIDE = 1, 3


def _trace():
    return profile(activities=[ProfilerActivity.CPU])


def _span_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("srba.")]


def _traced_snapshot():
    return ({k: (s.count, s.total) for k, s in TRACED.stats.items()},
            dict(TRACED.counters))


def test_scope_and_span_are_spans_of_a_trace():
    prof = Profiler()
    before = TRACED.stats["spans_outer.inner"].count
    with _trace() as p:
        with prof.scope("spans_outer"):
            with prof.scope("inner"):
                with span("spans_free"):
                    torch.ones(3).add_(1)
    names = _span_names(p)
    assert names.count("srba.spans_outer") == 1
    assert names.count("srba.spans_outer.inner") == 1
    assert names.count("srba.spans_free") == 1
    # Host stats as without a trace, and the same in the traced tally.
    assert prof.stats["spans_outer.inner"].count == 1
    assert TRACED.stats["spans_outer.inner"].count == before + 1
    assert "spans_free" not in prof.stats


def test_no_record_function_outside_a_trace(monkeypatch):
    calls = []

    def fake(name):
        calls.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(pm, "record_function", fake)
    prof = Profiler()
    snap = _traced_snapshot()
    with prof.scope("untraced"):
        with span("untraced_free"):
            pass
    prof.count("untraced_counter", 2)
    assert calls == []
    assert prof.stats["untraced"].count == 1
    assert prof.counters["untraced_counter"] == 2
    assert _traced_snapshot() == snap
    with _trace():
        with prof.scope("untraced"):
            with span("untraced_free"):
                pass
    assert calls == ["srba.untraced", "srba.untraced_free"]


def test_disabled_profiler_records_nothing():
    prof = Profiler(enabled=False)
    snap = _traced_snapshot()
    with _trace() as p:
        with prof.scope("disabled_scope"):
            torch.ones(2).add_(1)
        prof.count("disabled_counter")
    assert not prof.stats and not prof.counters
    assert _span_names(p) == []
    assert _traced_snapshot() == snap


def test_counters_reach_the_traced_tally_only_under_a_trace():
    prof = Profiler()
    c0 = TRACED.counters.get("tally_counter", 0)
    prof.count("tally_counter", 2)
    with _trace():
        prof.count("tally_counter", 3)
    assert prof.counters["tally_counter"] == 5
    assert TRACED.counters["tally_counter"] == c0 + 3


@pytest.mark.parametrize("traced,syncs", [(False, 1), (True, 0)])
def test_pgo_scope_waits_for_the_device_only_without_a_trace(
        monkeypatch, traced, syncs):
    """A PGO scope on a CUDA device synchronizes as it closes, except under
    a trace, where the trace gives its kernels' device time."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: seen.append(device))
    prof = Profiler()
    dev = torch.device("cuda")
    with _trace() if traced else contextlib.nullcontext():
        with gg._scope(prof, "pgo_cg", dev):
            pass
    assert len(seen) == syncs
    assert prof.stats["pgo_cg"].count == 1


def _engine():
    """tests/test_refine_map.py's 30-keyframe map, built without per-KF
    optimization, in the port."""
    world = tds.make_world_loop_2d(num_kfs=30, radius=8.0, num_landmarks=70,
                                   seed=6)
    ds = tds.observe(world, "RangeBearing2D", noise_std=0.004,
                     sensor_range=6.0, odo_noise_std=0.02, seed=6)
    eng = T.SrbaEngine(
        "RangeBearing2D", noise=NoiseIdentity(0.004),
        params=T.SrbaParams(max_tree_depth=4, max_optimize_depth=4),
        device="cpu")
    for k, frame in enumerate(ds.frames):
        eng.define_new_keyframe(
            [T.Observation(lm_id=m, z=z) for m, z in frame],
            edge_init={k - 1: ds.odometry[k - 1]} if k > 0 else None,
            run_local_optimization=False)
    return eng


def _real_edges(a):
    """A window's real edges from its bucket-padded arrays: the optimized
    ones lead, then the fixed ones that a valid row's path goes through."""
    valid = a.obs_valid > 0
    return max(int(np.count_nonzero(a.edge_opt)),
               int(a.path_edge[valid].max()) + 1)


@pytest.fixture(scope="module")
def refined():
    """The same map refined by one sweep without a trace and with one, each
    phase's per-window ``iters`` and ``num_obs`` captured from the batched
    solve."""
    mp = pytest.MonkeyPatch()
    agg = mw._agg_info
    seen = []

    def spy(info, real=None):
        seen.append((info["iters"].clone(), info["num_obs"].clone()))
        return agg(info, real)

    mp.setattr(mw, "_agg_info", spy)
    # Each phase's shape (E, L, N) as the step gets it, and its windows'
    # real edges, from the windows' padded arrays.
    shapes, edges = [], []
    make = mw.make_sweep_step

    def recording(cfg):
        step = make(cfg)

        def rec(*args):
            shapes.append(tuple(args[8:11]))
            return step(*args)
        return rec

    sweep = SrbaEngine._sweep_windows

    def sweep_windows(self, *args):
        wins = sweep(self, *args)
        if wins:
            edges.append([_real_edges(a) for a, *_ in wins])
        return wins

    mp.setattr(mw, "make_sweep_step", recording)
    mp.setattr(SrbaEngine, "_sweep_windows", sweep_windows)
    try:
        out = {}
        for traced in (False, True):
            eng = _engine()
            seen.clear()
            shapes.clear()
            edges.clear()
            snap = _traced_snapshot()
            with _trace() if traced else contextlib.nullcontext() as p:
                info = eng.refine_map(sweeps=SWEEPS, stride=STRIDE)
            out[traced] = dict(
                eng=eng, info=info, phases=list(seen), shapes=list(shapes),
                edges=list(edges),
                names=_span_names(p) if traced else None,
                traced_before=snap, traced_after=_traced_snapshot())
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_refine_map_scopes(refined, traced):
    r = refined[traced]
    stats = r["eng"].profiler.stats
    phases = len(r["phases"])
    assert phases >= 1
    assert stats["refine_map_phase"].count == phases      # key unchanged
    assert stats["refine_map_pack"].count == phases
    assert stats["refine_map_windows"].count == 2 * SWEEPS
    assert stats["refine_map_info"].count == 1
    assert not any(k.startswith("refine_map.") for k in stats)


def test_refine_map_spans_in_a_trace(refined):
    r = refined[True]
    names, phases = r["names"], len(r["phases"])
    trips = r["eng"]._solver_cfg.max_iters
    want = {"srba.refine_map": 1, "srba.refine_map_windows": 2 * SWEEPS,
            "srba.refine_map_pack": phases, "srba.refine_map_phase": phases,
            "srba.refine_map_info": 1, "srba.lm.normal_eqs": phases * trips,
            "srba.lm.solve_delta": phases * trips}
    assert {k: names.count(k) for k in want} == want
    assert refined[False]["names"] is None
    # The traced tally grew by the traced engine's scopes and counters,
    # and not by the untraced engine's.
    (s0, c0), (s1, c1) = r["traced_before"], r["traced_after"]
    eng = r["eng"].profiler
    for key in ("refine_map_windows", "refine_map_pack", "refine_map_phase",
                "refine_map_info"):
        assert s1[key][0] - s0.get(key, (0, 0.0))[0] == eng.stats[key].count
    for key in ("refine_obs_rows", "refine_window_trips"):
        assert c1[key] - c0.get(key, 0) == eng.counters[key]
    u = refined[False]
    assert u["traced_after"] == u["traced_before"]


@pytest.mark.parametrize("traced", [False, True])
def test_refine_map_counters(refined, traced):
    r = refined[traced]
    c = r["eng"].profiler.counters
    iters = sum(int(it.sum()) for it, _ in r["phases"])
    rows = sum(int(n.sum()) for _, n in r["phases"])
    windows = sum(int(it.shape[0]) for it, _ in r["phases"])
    assert c["refine_window_trips"] == iters
    assert 0 < c["refine_window_trips"] <= c["refine_window_trip_slots"]
    assert c["refine_window_trip_slots"] == \
        windows * r["eng"]._solver_cfg.max_iters
    assert c["refine_obs_rows"] == rows
    assert 0 < c["refine_obs_rows"] <= c["refine_obs_slots"]
    shapes, edges = r["shapes"], r["edges"]
    assert len(shapes) == len(edges) == len(r["phases"])
    assert c["refine_edge_slots"] == sum(
        it.shape[0] * E for (it, _), (E, _, _) in zip(r["phases"], shapes))
    assert c["refine_edge_rows"] == sum(map(sum, edges))
    assert 0 < c["refine_edge_rows"] <= c["refine_edge_slots"]
    for (E, _, _), real in zip(shapes, edges):  # the phase's real maximum
        assert E % 8 == 0 and E - 8 < max(real) <= E, (E, real)
    assert r["info"]["windows"] == windows


def test_refine_map_bitwise_equal_with_and_without_a_trace(refined):
    a, b = refined[False], refined[True]
    dma, dmb = a["eng"].device_master, b["eng"].device_master
    assert torch.equal(dma.pose, dmb.pose)
    assert torch.equal(dma.lm, dmb.lm)
    assert a["info"] == b["info"]
    for (ia, na), (ib, nb) in zip(a["phases"], b["phases"]):
        assert torch.equal(ia, ib) and torch.equal(na, nb)
    assert np.isfinite(a["info"]["err_final"])


def test_agg_info_counts_the_trips_of_real_windows():
    info = {"err_init": torch.ones(3), "err_final": torch.ones(3),
            "iters": torch.tensor([3, 5, 1], dtype=torch.int32),
            "lam": torch.ones(3), "num_obs": torch.ones(3)}
    assert float(mw._agg_info(info)["trips"]) == 9.0
    real = torch.tensor([True, True, False])
    agg = mw._agg_info(info, real)
    assert float(agg["trips"]) == 8.0 and agg["trips"].dtype == torch.float32
    assert int(agg["iters"]) == 5        # the JAX package's maximum


def test_mesh_step_leaves_padding_windows_out_of_the_trips(monkeypatch):
    """A padding window (an all-zero row, no ownership) runs an LM trip of
    its own; the mesh step's trip sum leaves it out."""
    from tests.test_torch_sharding import one_rank_mesh

    seen, iters = [], []
    make, agg = mw.make_sweep_step, mw._agg_info

    def recording(cfg):
        step = make(cfg)

        def rec(*args):
            if not seen:
                seen.extend(a.clone() if torch.is_tensor(a) else a
                            for a in args)
            return step(*args)
        return rec

    def spy(info, real=None):
        iters.append(info["iters"].clone())
        return agg(info, real)

    monkeypatch.setattr(mw, "make_sweep_step", recording)
    eng = _engine()
    eng.refine_map(sweeps=1, stride=STRIDE)
    pose, prior, lm, ints, obs_z, *rest = seen
    monkeypatch.setattr(mw, "_agg_info", spy)
    padded = mw.make_sweep_step_mesh(eng._solver_cfg, one_rank_mesh())(
        pose, prior, lm, np.concatenate([ints, np.zeros_like(ints[:1])]),
        np.concatenate([obs_z, obs_z[:1]]), *rest)[2]
    it = iters[-1]
    assert it.shape[0] == ints.shape[0] + 1 and int(it[-1]) >= 1
    assert float(padded["trips"]) == float(it[:-1].sum()) > 0
