import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import lie


def random_w(rng, n=64, scale=2.0):
    # Directions uniform on the sphere, magnitudes < pi (log is only the
    # inverse of exp inside the principal ball).
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    mag = rng.uniform(0.0, min(scale, 3.1), size=(n, 1))
    return jnp.asarray(v * mag, dtype=jnp.float32)


def test_exp_log_so3_roundtrip(rng):
    w = random_w(rng, scale=3.0)
    R = lie.exp_so3(w)
    w2 = lie.log_so3(R)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=5e-4)


def test_exp_so3_orthonormal(rng):
    w = random_w(rng)
    R = lie.exp_so3(w)
    eye = jnp.eye(3)[None].repeat(R.shape[0], axis=0)
    np.testing.assert_allclose(np.asarray(R @ jnp.swapaxes(R, -1, -2)), np.asarray(eye), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jnp.linalg.det(R)), 1.0, atol=1e-5)


def test_exp_so3_small_angle():
    w = jnp.asarray([[1e-9, -1e-9, 1e-10], [0.0, 0.0, 0.0]], dtype=jnp.float32)
    R = lie.exp_so3(w)
    assert np.all(np.isfinite(np.asarray(R)))
    np.testing.assert_allclose(np.asarray(R[1]), np.eye(3), atol=1e-7)
    # Gradient is finite at zero.
    g = jax.grad(lambda v: jnp.sum(lie.exp_so3(v)))(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g)))


def test_log_so3_near_pi():
    axis = np.array([1.0, 2.0, -0.5])
    axis /= np.linalg.norm(axis)
    for theta in [np.pi - 1e-4, np.pi - 1e-2]:
        w = jnp.asarray(axis * theta, dtype=jnp.float32)
        R = lie.exp_so3(w)
        w2 = np.asarray(lie.log_so3(R))
        np.testing.assert_allclose(w2, np.asarray(w), atol=5e-3)


def test_right_jacobian_finite_diff(rng):
    w = jnp.asarray(rng.normal(size=3).astype(np.float32))
    Jr = lie.right_jacobian_so3(w)
    # exp(w + Jr^{-1}... ) definition: exp(w + dw) ~= exp(w) exp(Jr dw)
    for i in range(3):
        dw = jnp.zeros(3).at[i].set(1e-4)
        lhs = lie.exp_so3(w + dw)
        rhs = lie.exp_so3(w) @ lie.exp_so3(Jr @ dw)
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-6)


def test_inv_right_jacobian(rng):
    w = jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32))
    J = lie.right_jacobian_so3(w)
    Jinv = lie.inv_right_jacobian_so3(w)
    eye = jnp.eye(3)[None].repeat(8, axis=0)
    np.testing.assert_allclose(np.asarray(J @ Jinv), np.asarray(eye), atol=1e-4)


def test_quat_roundtrip(rng):
    w = random_w(rng, scale=3.0)
    R = lie.exp_so3(w)
    R2 = lie.mat_from_quat(lie.quat_from_mat(R))
    np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-5)


def test_normalize_rotation(rng):
    w = random_w(rng, n=16)
    R = lie.exp_so3(w)
    noisy = R + 1e-3 * jnp.asarray(rng.normal(size=R.shape), dtype=jnp.float32)
    Rn = lie.normalize_rotation(noisy)
    eye = jnp.eye(3)[None].repeat(16, axis=0)
    np.testing.assert_allclose(
        np.asarray(Rn @ jnp.swapaxes(Rn, -1, -2)), np.asarray(eye), atol=1e-5
    )


def test_se3_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(32, 6)).astype(np.float32))
    R, t = lie.exp_se3(xi)
    xi2 = lie.log_se3(R, t)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=1e-4)


def test_se3_compose_inverse(rng):
    xi = jnp.asarray(rng.normal(size=(4, 6)).astype(np.float32))
    R, t = lie.exp_se3(xi)
    Ri, ti = lie.se3_inv(R, t)
    Rc, tc = lie.se3_compose(R, t, Ri, ti)
    np.testing.assert_allclose(np.asarray(Rc), np.eye(3)[None].repeat(4, 0), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tc), 0.0, atol=1e-5)


def test_sim3_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(16, 7)).astype(np.float32) * 0.5)
    R, t, s = lie.exp_sim3(xi)
    xi2 = lie.log_sim3(R, t, s)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=1e-3)


def test_sim3_apply_compose(rng):
    xi = jnp.asarray(rng.normal(size=(7,)).astype(np.float32) * 0.5)
    R, t, s = lie.exp_sim3(xi)
    Ri, ti, si = lie.sim3_inv(R, t, s)
    p = jnp.asarray(rng.normal(size=(10, 3)).astype(np.float32))
    q = lie.sim3_apply(R, t, s, p)
    p2 = lie.sim3_apply(Ri, ti, si, q)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p), atol=1e-4)
