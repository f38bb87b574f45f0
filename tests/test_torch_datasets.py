"""Config #5's data generators of the port (``make_world_loop_3d_large``,
``observe_sparse``) against the JAX package's, on a small world: numpy on
the host in both, so worlds, frames, observations and odometry must be
bitwise equal."""

import numpy as np
import pytest

from srba_tpu.models import observations as jobs
from srba_tpu.utils import datasets as jds
from srba_tpu_torch.models import observations as tobs
from srba_tpu_torch.utils import datasets as tds


def _calibs(model):
    if model == "StereoCamera":
        kw = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, baseline=0.12)
        return jobs.StereoCalib.make(**kw), tobs.StereoCalib.make(**kw)
    if model in ("MonocularCamera", "RGBDCamera"):
        return jobs.CameraCalib.make(), tobs.CameraCalib.make()
    return None, None


def test_make_world_loop_3d_large_bitwise():
    kw = dict(num_kfs=200, radius=30.0, num_landmarks=300, revolutions=2.5,
              seed=7)
    wj, wt = jds.make_world_loop_3d_large(**kw), tds.make_world_loop_3d_large(
        **kw)
    assert wt.group_name == wj.group_name == "SE3"
    np.testing.assert_array_equal(wt.gt_poses, wj.gt_poses)
    np.testing.assert_array_equal(wt.landmarks, wj.landmarks)
    assert wt.gt_poses.dtype == wt.landmarks.dtype == np.float32


@pytest.mark.parametrize("model, noise, odo", [
    ("MonocularCamera", 0.3, 0.005),   # config #5's
    ("MonocularCamera", 0.0, 0.0),
    ("StereoCamera", 0.3, 0.01),
    ("RGBDCamera", 0.15, 0.01),
    ("RangeBearing3D", 0.005, 0.01),
])
def test_observe_sparse_bitwise(model, noise, odo):
    kw = dict(num_kfs=200, radius=30.0, num_landmarks=300, revolutions=2.5,
              seed=7)
    wj, wt = jds.make_world_loop_3d_large(**kw), tds.make_world_loop_3d_large(
        **kw)
    cj, ct = _calibs(model)
    dj = jds.observe_sparse(wj, model, calib=cj, noise_std=noise,
                            sensor_range=7.0, odo_noise_std=odo, seed=7)
    dt = tds.observe_sparse(wt, model, calib=ct, noise_std=noise,
                            sensor_range=7.0, odo_noise_std=odo, seed=7)
    assert dt.obs_model == dj.obs_model == model
    assert len(dt.frames) == len(dj.frames) == 200
    assert sum(len(f) for f in dt.frames) > 200
    for fj, ft in zip(dj.frames, dt.frames):
        assert [m for m, _ in ft] == [m for m, _ in fj]
        for (_, zj), (_, zt) in zip(fj, ft):
            assert zt.dtype == np.float32
            np.testing.assert_array_equal(zt, zj)
    assert len(dt.odometry) == len(dj.odometry) == 199
    for oj, ot in zip(dj.odometry, dt.odometry):
        np.testing.assert_array_equal(ot, oj)
