import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_jax.ops import imu, lie


def make_calib():
    return imu.ImuCalib.create(
        Rbc=np.eye(3), tbc=np.zeros(3),
        noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3,
        freq=200.0,
    )


def simulate_trajectory(rng, n=200, dt=0.005, bias_g=None, bias_a=None):
    """Simulate body moving with sinusoidal acceleration + rotation; return
    true start/end states and ideal IMU samples (body frame, with gravity)."""
    bias_g = np.zeros(3) if bias_g is None else bias_g
    bias_a = np.zeros(3) if bias_a is None else bias_a
    g = np.array([0.0, 0.0, -imu.GRAVITY_VALUE])

    R = np.eye(3)
    v = np.array([0.3, -0.1, 0.05])
    p = np.zeros(3)
    Rs, vs, ps = [R], [v], [p]
    accs, gyros = [], []
    for k in range(n):
        t = k * dt
        w_world = np.array([0.4 * np.sin(t * 3), 0.3, 0.2 * np.cos(t * 2)])
        a_world = np.array([0.5 * np.cos(t * 5), 0.4 * np.sin(t * 4), 0.1])
        # body-frame measurements (specific force excludes gravity)
        gyro = R.T @ w_world
        acc = R.T @ (a_world - g)
        accs.append(acc + bias_a)
        gyros.append(gyro + bias_g)
        # integrate ground truth with the same discretization the
        # preintegrator uses (constant sample over dt)
        p = p + v * dt + 0.5 * a_world * dt * dt
        v = v + a_world * dt
        R = R @ np.asarray(lie.exp_so3(jnp.asarray(gyro * dt, jnp.float32)))
        Rs.append(R); vs.append(v); ps.append(p)
    return (
        np.stack(accs).astype(np.float32),
        np.stack(gyros).astype(np.float32),
        np.full(n, dt, np.float32),
        (Rs[0], vs[0], ps[0]),
        (Rs[-1], vs[-1], ps[-1]),
    )


def test_preintegration_matches_ground_truth(rng):
    acc, gyro, dts, (R0, v0, p0), (R1, v1, p1) = simulate_trajectory(rng)
    calib = make_calib()
    pre = imu.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                        jnp.zeros(3), jnp.zeros(3), calib)
    dT = float(pre.dT)
    g = np.array([0.0, 0.0, -imu.GRAVITY_VALUE])
    # Recover end state from preintegrated deltas (Forster eqs).
    R1_hat = R0 @ np.asarray(pre.dR)
    v1_hat = v0 + g * dT + R0 @ np.asarray(pre.dV)
    p1_hat = p0 + v0 * dT + 0.5 * g * dT**2 + R0 @ np.asarray(pre.dP)
    # float32 chain over 200 steps: allow a few-milliunit drift.
    np.testing.assert_allclose(R1_hat, R1, atol=5e-3)
    np.testing.assert_allclose(v1_hat, v1, atol=5e-3)
    np.testing.assert_allclose(p1_hat, p1, atol=5e-3)


def test_padding_is_noop(rng):
    acc, gyro, dts, _, _ = simulate_trajectory(rng, n=50)
    calib = make_calib()
    pre = imu.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                        jnp.zeros(3), jnp.zeros(3), calib)
    # Pad with 30 zero-dt samples: result must be identical.
    pad = 30
    acc_p = np.concatenate([acc, np.zeros((pad, 3), np.float32)])
    gyro_p = np.concatenate([gyro, np.zeros((pad, 3), np.float32)])
    dts_p = np.concatenate([dts, np.zeros(pad, np.float32)])
    pre_p = imu.integrate(jnp.asarray(acc_p), jnp.asarray(gyro_p), jnp.asarray(dts_p),
                          jnp.zeros(3), jnp.zeros(3), calib)
    np.testing.assert_allclose(np.asarray(pre_p.dR), np.asarray(pre.dR), atol=1e-6)
    np.testing.assert_allclose(np.asarray(pre_p.dP), np.asarray(pre.dP), atol=1e-6)
    np.testing.assert_allclose(np.asarray(pre_p.C), np.asarray(pre.C), atol=1e-9)
    np.testing.assert_allclose(float(pre_p.dT), float(pre.dT), atol=1e-6)


def test_bias_jacobian_first_order(rng):
    """GetDelta* first-order corrections should match re-integration with
    the perturbed bias (ImuTypes.cc:373-393)."""
    acc, gyro, dts, _, _ = simulate_trajectory(rng, n=100)
    calib = make_calib()
    b0g, b0a = jnp.zeros(3), jnp.zeros(3)
    pre = imu.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), b0g, b0a, calib)
    db_g = jnp.asarray([0.002, -0.001, 0.0015])
    db_a = jnp.asarray([0.01, -0.02, 0.005])
    pre2 = imu.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                         b0g + db_g, b0a + db_a, calib)
    dR_corr = imu.delta_rotation(pre, b0g + db_g)
    dV_corr = imu.delta_velocity(pre, b0g + db_g, b0a + db_a)
    dP_corr = imu.delta_position(pre, b0g + db_g, b0a + db_a)
    np.testing.assert_allclose(np.asarray(dR_corr), np.asarray(pre2.dR), atol=5e-4)
    np.testing.assert_allclose(np.asarray(dV_corr), np.asarray(pre2.dV), atol=2e-3)
    np.testing.assert_allclose(np.asarray(dP_corr), np.asarray(pre2.dP), atol=2e-3)


def test_merge_matches_full_integration(rng):
    acc, gyro, dts, _, _ = simulate_trajectory(rng, n=120)
    calib = make_calib()
    full = imu.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                         jnp.zeros(3), jnp.zeros(3), calib)
    p1 = imu.integrate(jnp.asarray(acc[:60]), jnp.asarray(gyro[:60]), jnp.asarray(dts[:60]),
                       jnp.zeros(3), jnp.zeros(3), calib)
    p2 = imu.integrate(jnp.asarray(acc[60:]), jnp.asarray(gyro[60:]), jnp.asarray(dts[60:]),
                       jnp.zeros(3), jnp.zeros(3), calib)
    merged = imu.merge(p1, p2, calib)
    np.testing.assert_allclose(np.asarray(merged.dR), np.asarray(full.dR), atol=1e-5)
    np.testing.assert_allclose(np.asarray(merged.dV), np.asarray(full.dV), atol=1e-4)
    np.testing.assert_allclose(np.asarray(merged.dP), np.asarray(full.dP), atol=1e-4)
    np.testing.assert_allclose(np.asarray(merged.JRg), np.asarray(full.JRg), atol=1e-4)
    np.testing.assert_allclose(np.asarray(merged.JPa), np.asarray(full.JPa), atol=1e-4)


def test_covariance_psd(rng):
    acc, gyro, dts, _, _ = simulate_trajectory(rng, n=100)
    calib = make_calib()
    pre = imu.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                        jnp.zeros(3), jnp.zeros(3), calib)
    C = np.asarray(pre.C)
    eig = np.linalg.eigvalsh(0.5 * (C + C.T))
    assert eig.min() > -1e-12
    info = np.asarray(imu.information_matrix(pre))
    assert np.all(np.isfinite(info))


def test_midpoint_samples():
    ts = np.array([0.0, 0.01, 0.02, 0.03])
    acc = np.tile(np.array([[1.0, 0.0, 0.0]]), (4, 1))
    gyro = np.zeros((4, 3))
    a, g, dt = imu.midpoint_samples(acc, gyro, ts, 0.005, 0.025)
    np.testing.assert_allclose(dt.sum(), 0.02, atol=1e-9)
    np.testing.assert_allclose(a[:, 0], 1.0)
