"""The generators give the same work on every seed: the same observation
table (which keyframe sees which landmark), with only the values moved by
the seed; and the edges the reference works out from the odometry."""

import json
import os

import numpy as np

from conftest import PERFBENCH
from reference import local_areas
from worlds import street_grid


def _config(name):
    with open(os.path.join(PERFBENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_street_grid_same_work_every_seed():
    cfg = _config("stereo_kitti")
    a = street_grid.make_drive(cfg, 1, num_kfs=60)
    b = street_grid.make_drive(cfg, 2**33 + 17, num_kfs=60)
    assert np.array_equal(a.obs_kf, b.obs_kf)
    assert np.array_equal(a.obs_lm, b.obs_lm)
    assert np.array_equal(a.frame_start, b.frame_start)
    assert np.array_equal(a.gt_poses, b.gt_poses)
    assert not np.array_equal(a.obs_z, b.obs_z)
    assert not np.array_equal(a.odometry, b.odometry)
    per_kf = np.diff(a.frame_start)
    assert 300 < per_kf.mean() < 500


def test_street_grid_same_seed_same_inputs():
    cfg = _config("stereo_kitti")
    a = street_grid.make_drive(cfg, 99, num_kfs=20)
    b = street_grid.make_drive(cfg, 99, num_kfs=20)
    assert np.array_equal(a.obs_z, b.obs_z)
    assert np.array_equal(a.odometry, b.odometry)


def test_street_grid_odometry_is_relative_motion():
    cfg = json.loads(json.dumps(_config("stereo_kitti")))
    cfg["world"]["odometry_noise"] = 0.0
    d = street_grid.make_drive(cfg, 3, num_kfs=40)
    G = d.gt_poses
    for k in (1, 17, 39):
        back = street_grid.compose(G[k], d.odometry[k - 1].astype(np.float64))
        assert np.allclose(back[:3], G[k - 1, :3], atol=1e-4)


def test_fixed_grid_priors_are_the_odometry_relative_motion():
    cfg = json.loads(json.dumps(_config("stereo_kitti")))
    cfg["world"]["odometry_noise"] = 0.0
    d = street_grid.make_drive(cfg, 4, num_kfs=35)
    ef, et, prior, w = local_areas.fixed_grid_edges(35, 10, d.odometry, 0.05)
    assert list(zip(ef[:12], et[:12])) == [
        (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (8, 0),
        (9, 0), (10, 0), (11, 10), (12, 10)]
    G = d.gt_poses
    want = street_grid.compose(street_grid.inverse(G[ef]), G[et])
    dt, dr = local_areas.pose_gaps(prior, want)
    assert dt.max() < 1e-4 and dr.max() < 1e-5
    assert np.allclose(w, 400.0 / (ef - et))
