"""The --fisheye synthetic generator's ray grid must agree with the
framework's KB8 camera model: unprojecting every pixel with the
generator's independent numpy Newton solve and re-projecting through
`ops.cameras.kb8_project` has to land back on the same pixel. This keeps
the config-4 (TUM-VI stereo-fisheye) at-scale replay honest — the imagery
is produced by a solver written separately from the code under test."""

import os
import sys

import numpy as np
import jax.numpy as jnp

from orbslam3_jax.ops import cameras as cam

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import make_synth_euroc as gen  # noqa: E402


def test_kb8_dir_grid_roundtrip():
    for intr in (gen.FE_INTR_L, gen.FE_INTR_R):
        dirs = gen.kb8_dir_grid((gen.FE_W, gen.FE_H), intr)
        assert dirs.shape == (gen.FE_H, gen.FE_W, 3)
        # unit rays
        nrm = np.linalg.norm(dirs, axis=-1)
        np.testing.assert_allclose(nrm, 1.0, atol=1e-5)
        params = jnp.asarray(intr, jnp.float32)
        # Keep pixels whose rays stay in front of the camera (the 512x512
        # corners exceed 90 deg for these TUM-VI-like intrinsics; the
        # polynomial projection model is only injective forward of that).
        u, v = np.meshgrid(np.arange(gen.FE_W), np.arange(gen.FE_H))
        front = dirs[..., 2] > 0.05
        uv = np.asarray(cam.kb8_project(params, jnp.asarray(dirs[front])))
        exp = np.stack([u[front], v[front]], -1).astype(np.float64)
        err = np.abs(uv - exp).max()
        assert err < 0.02, f"max roundtrip error {err} px"


def test_fisheye_sequence_layout(tmp_path):
    """Generator writes the mav0 layout + a parseable KB8 rig settings
    file (Camera2/Tlr/lapping keys the reference's TUM_512.yaml uses)."""
    import subprocess

    out = tmp_path / "fe"
    subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(gen.__file__),
                                      "make_synth_euroc.py"),
         str(out), "--frames", "3", "--fisheye"],
        check=True, capture_output=True, timeout=300,
    )
    from orbslam3_jax import config as cfg

    s = cfg.load_settings(str(out / "settings.yaml"))
    assert s.camera.model == cam.CameraModel.KB8
    assert s.camera.params2 is not None and s.camera.T_c1_c2 is not None
    assert abs(s.camera.T_c1_c2[0, 3] - gen.FE_BASELINE_M) < 1e-6
    assert s.camera.lapping1 == (0.0, float(gen.FE_W - 1))
    assert s.imu is not None
    for c in ("cam0", "cam1", "imu0", "state_groundtruth_estimate0"):
        assert (out / "mav0" / c / "data.csv").exists()
    assert len(list((out / "mav0" / "cam0" / "data").iterdir())) == 3
