"""The port's INI sensor configuration (srba_tpu_torch.io.config_ini): the
twins of the INI cases of tests/test_ini_visitor.py, and the parsed values
against the JAX package's on the same files.

Tolerances: calibration values and noise matrices equal to the JAX
package's exactly; the mount pose from ``SE3.from_xyz_ypr`` within atol
1e-6 (f32 trig of half angles, the bound of tests/test_torch_lie.py).
"""

import dataclasses

import numpy as np
import pytest

from srba_tpu.io.config_ini import load_noise_ini as jax_load_noise_ini
from srba_tpu.io.config_ini import load_sensor_ini as jax_load_sensor_ini
from srba_tpu_torch.io.config_ini import load_noise_ini, load_sensor_ini
from srba_tpu_torch.models.noise import NoiseConstantMatrix, NoiseIdentity
from srba_tpu_torch.models.observations import CameraCalib, StereoCalib
from srba_tpu_torch.models.sensor_pose import SensorPoseSE3
from tests.test_ini_visitor import INI


def _same_calib(calib, jcalib):
    assert type(calib).__name__ == type(jcalib).__name__
    for f in dataclasses.fields(calib):
        a, b = getattr(calib, f.name), np.asarray(getattr(jcalib, f.name))
        assert np.float32(a) == b and np.asarray(a).dtype == b.dtype, f.name


def test_load_sensor_ini(tmp_path):
    p = tmp_path / "sensor.ini"
    p.write_text(INI)
    calib, pose = load_sensor_ini(str(p), "StereoCamera")
    assert isinstance(calib, StereoCalib)
    assert float(calib.fx) == 210.0
    assert abs(float(calib.baseline) - 0.15) < 1e-6
    assert isinstance(pose, SensorPoseSE3) and not pose.is_identity
    mono_calib, _ = load_sensor_ini(str(p), "MonocularCamera")
    assert isinstance(mono_calib, CameraCalib)
    assert float(mono_calib.fx) == 300.0
    for model in ("StereoCamera", "MonocularCamera"):
        (c, sp), (jc, jsp) = (load_sensor_ini(str(p), model),
                              jax_load_sensor_ini(str(p), model))
        _same_calib(c, jc)
        jpose = np.asarray(jsp._pose)
        tpose = sp._pose
        assert tpose.dtype == np.float32 and tpose.shape == (7,)
        np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-6)


def test_load_sensor_ini_missing_sections(tmp_path):
    p = tmp_path / "empty.ini"
    p.write_text("[OTHER]\nfoo = 1\n")
    calib, pose = load_sensor_ini(str(p), "StereoCamera")
    assert calib is None and pose is None
    assert load_noise_ini(str(p), 4) is None
    assert jax_load_noise_ini(str(p), 4) is None


@pytest.mark.parametrize("section, kind", [
    ("[OBS_NOISE]\ntype = identity\nstd = 0.25\n", NoiseIdentity),
    ("[OBS_NOISE]\ntype = constant_matrix\ncov = 0.01 0 0 0.04\n",
     NoiseConstantMatrix),
])
def test_load_noise_ini(tmp_path, section, kind):
    """The [OBS_NOISE] section gives the JAX package's noise model, with the
    same whitener."""
    p = tmp_path / "noise.ini"
    p.write_text(section)
    noise, jnoise = load_noise_ini(str(p), 2), jax_load_noise_ini(str(p), 2)
    assert isinstance(noise, kind) and noise.name == jnoise.name
    np.testing.assert_array_equal(noise.whitener(2),
                                  np.asarray(jnoise.whitener(2)))


def test_noise_ini_errors(tmp_path):
    p = tmp_path / "bad.ini"
    p.write_text("[OBS_NOISE]\ntype = constant_matrix\ncov = 1 0 0\n")
    with pytest.raises(ValueError, match="row-major"):
        load_noise_ini(str(p), 2)
    p.write_text("[OBS_NOISE]\ntype = student\n")
    with pytest.raises(ValueError, match="unknown"):
        load_noise_ini(str(p), 2)
