import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import cameras as cam

# EuRoC cam0 calibration (Examples/Monocular/EuRoC.yaml in the reference).
EUROC = cam.make_pinhole(458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
# TUM-VI 512 fisheye calibration (Examples/Monocular/TUM_512.yaml).
TUMVI = cam.make_kb8(190.978477, 190.973307, 254.931706, 256.897442, 0.003482389402, 0.000715034845, -0.002053236141, 0.000202936736)


def random_points(rng, n=256):
    x = rng.uniform(-0.6, 0.6, size=(n,))
    y = rng.uniform(-0.45, 0.45, size=(n,))
    z = rng.uniform(0.5, 10.0, size=(n,))
    return jnp.asarray(np.stack([x * z, y * z, z], axis=-1), dtype=jnp.float32)


@pytest.mark.parametrize(
    "model,params",
    [(cam.CameraModel.PINHOLE, EUROC), (cam.CameraModel.KB8, TUMVI)],
)
def test_project_unproject_roundtrip(rng, model, params):
    Xc = random_points(rng)
    uv = cam.project(model, params, Xc)
    ray = cam.unproject(model, params, uv)
    # Ray should point at the 3D point: scale ray by true depth.
    rec = ray * Xc[..., 2:3]
    np.testing.assert_allclose(np.asarray(rec), np.asarray(Xc), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize(
    "model,params",
    [(cam.CameraModel.PINHOLE, EUROC), (cam.CameraModel.KB8, TUMVI)],
)
def test_project_jacobian_matches_autodiff(rng, model, params):
    Xc = random_points(rng, n=32)
    J = cam.project_jac(model, params, Xc)
    J_auto = jax.vmap(jax.jacfwd(lambda p: cam.project(model, params, p)))(Xc)
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_auto), rtol=1e-3, atol=1e-3)


def test_pinhole_zero_distortion_is_linear():
    params = cam.make_pinhole(500.0, 500.0, 320.0, 240.0)
    Xc = jnp.asarray([[0.1, -0.2, 2.0]], dtype=jnp.float32)
    uv = cam.pinhole_project(params, Xc)
    np.testing.assert_allclose(
        np.asarray(uv[0]), [500 * 0.05 + 320, 500 * -0.1 + 240], rtol=1e-6
    )


def test_kb8_center_point():
    uv = cam.kb8_project(TUMVI, jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32))
    np.testing.assert_allclose(np.asarray(uv[0]), [254.931706, 256.897442], atol=1e-3)


def test_kb8_wide_angle(rng):
    # Fisheye handles rays >90 deg off-axis; check a 100-deg ray roundtrips.
    theta = np.deg2rad(80.0)
    Xc = jnp.asarray([[np.sin(theta), 0.0, np.cos(theta)]], dtype=jnp.float32)
    uv = cam.kb8_project(TUMVI, Xc)
    ray = cam.kb8_unproject(TUMVI, uv)
    ray = ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(ray[0]), np.asarray(Xc[0]), atol=1e-3)
