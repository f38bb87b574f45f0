"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the run is on the CPU, at a size a
test can hold) and everything else of a run is driven, for each fault a
cell can have, at a size where a sweep after the warm one still moves
the map.  No cell runs across chips, so the exchange between chips
has no fault to plant."""

import pytest

from conftest import SMALL, tiny_run


def test_sound_runs_are_correct(spec):
    assert tiny_run(spec, "stereo_kitti.refine", 2**31 + 11,
                    sizes=SMALL)["correct"]


def _refine_unchanged(monkeypatch):
    """The map returned as it came, with the window count a sweep has."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    orig = SrbaEngine.refine_map
    counted = {}

    def refine_map(self, *a, **k):
        if "windows" not in counted:      # the warm sweep runs for real
            counted.update(orig(self, *a, **k))
            return dict(counted)
        return dict(counted)
    monkeypatch.setattr(SrbaEngine, "refine_map", refine_map)


def _refine_first_phase_out(monkeypatch):
    """Each call's first phase solved with no windows, the count kept."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    orig_map, orig_sweep = SrbaEngine.refine_map, SrbaEngine._sweep_windows
    seen = {"phase": 0, "dropped": 0}

    def refine_map(self, *a, **k):
        seen.update(phase=0, dropped=0)
        info = orig_map(self, *a, **k)
        return dict(info, windows=info["windows"] + seen["dropped"])

    def sweep_windows(self, roots, depth, tree_depth):
        wins = orig_sweep(self, roots, depth, tree_depth)
        seen["phase"] += 1
        if seen["phase"] % 2 == 1:
            seen["dropped"] += len(wins)
            return []
        return wins
    monkeypatch.setattr(SrbaEngine, "refine_map", refine_map)
    monkeypatch.setattr(SrbaEngine, "_sweep_windows", sweep_windows)


def _refine_prior_altered(monkeypatch):
    """One edge's measurement prior moved by 10 cm as it is created."""
    from srba_tpu_torch.engine.engine import SrbaEngine
    orig = SrbaEngine._add_edge

    def add_edge(self, from_kf, to_kf, pose, *a, **k):
        if from_kf == 7:
            pose = pose.copy()
            pose[0] += 0.1
        return orig(self, from_kf, to_kf, pose, *a, **k)
    monkeypatch.setattr(SrbaEngine, "_add_edge", add_edge)


def _refine_half_windows(monkeypatch):
    from srba_tpu_torch.engine.engine import SrbaEngine
    orig = SrbaEngine._sweep_windows

    def sweep_windows(self, roots, depth, tree_depth):
        wins = orig(self, roots, depth, tree_depth)
        return wins[: len(wins) // 2]
    monkeypatch.setattr(SrbaEngine, "_sweep_windows", sweep_windows)


def _refine_altered(monkeypatch):
    from srba_tpu_torch.engine.engine import SrbaEngine
    orig = SrbaEngine.refine_map

    def refine_map(self, *a, **k):
        info = orig(self, *a, **k)
        dm = self.device_master
        dm.lm[self.state.num_lms // 2] += 0.5
        dm.dirty = True
        return info
    monkeypatch.setattr(SrbaEngine, "refine_map", refine_map)


@pytest.mark.parametrize("fault", [_refine_unchanged,
                                   _refine_first_phase_out,
                                   _refine_half_windows, _refine_altered,
                                   _refine_prior_altered])
def test_refine_fault_is_not_correct(spec, monkeypatch, fault):
    fault(monkeypatch)
    res = tiny_run(spec, "stereo_kitti.refine", 2**31 + 12, sizes=SMALL)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
