"""AsyncMapper: the sliced mapping pass (tracking/mapping overlap —
`pipeline/async_mapping.py`, re-expressing the reference's LocalMapping
thread `System.cc:138` / `LocalMapping::Run`) produces the same map a
synchronous pass does, drains on flush, and honors interrupt/abort."""

import numpy as np
import pytest

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.system import System, Sensor
from orbslam3_jax.pipeline.tracking import TrackState
from orbslam3_jax.eval.ate import ate_rmse

from test_e2e_mono import H, W, FOCAL, make_world, render, camera_path


def _run(rng_seed, n_frames=12, async_mapping=False):
    rng = np.random.default_rng(rng_seed)
    params = cam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    pts, shades = make_world(rng)
    poses = camera_path(n_frames)
    orb = feat.OrbParams(n_features=400, n_levels=3)
    slam = System(
        Sensor.MONOCULAR, cam.CameraModel.PINHOLE, params, (W, H),
        orb_params=orb, Kmax=32, Pmax=4096,
    )
    if async_mapping:
        slam.enable_async_mapping()
    for k, (R, t) in enumerate(poses):
        img = render(params, R, t, pts, shades)
        slam.track_monocular(img, k * 0.1)
    slam.shutdown()  # drains pending mapping passes
    return slam, poses


@pytest.mark.slow
def test_async_matches_sync_quality():
    # 16 frames: long enough for the 5-stage sliced passes to leave idle
    # windows where the mono policy may insert (mono never inserts while
    # the mapper is busy, `Tracking.cc:2694-2713`).
    slam_a, poses = _run(7, n_frames=16, async_mapping=True)
    assert slam_a.tracking_state == TrackState.OK
    assert slam_a.async_mapper.n_completed >= 1
    assert slam_a.async_mapper.idle()  # shutdown drained everything
    assert slam_a.n_keyframes >= 2
    assert slam_a.n_map_points > 50

    ts, pos = slam_a.get_trajectory()
    gt_ts = np.asarray([k * 0.1 for k in range(len(poses))])
    gt = np.stack([-R.T @ t for R, t in poses])
    rmse = ate_rmse(ts, pos, gt_ts, gt, with_scale=True)
    # Same ballpark the sync e2e test verifies.
    assert rmse < 0.05, rmse


def test_executor_protocol():
    """Queue/idle/interrupt/abort semantics without any device work."""
    from orbslam3_jax.pipeline.async_mapping import AsyncMapper

    calls = []

    class FakeMapper:
        preints = {}
        interrupt_ba = False

        def s0(self, k):
            calls.append(("s0", k, self.interrupt_ba))

        def s1(self, k):
            calls.append(("s1", k, self.interrupt_ba))

        STAGES = (s0, s1)

        def process_keyframe(self, k, initial=False, preint=None):
            calls.append(("init", k))

    done = []
    m = FakeMapper()
    ex = AsyncMapper(m, downstream=[lambda k: done.append(k)])
    assert ex.idle()
    ex.submit(3, preint="p3")
    assert m.preints[3] == "p3"  # recorded at insertion, not at stage time
    ex.submit(4)
    assert ex.queue_len() == 2 and not ex.idle()
    ex.tick()  # kf 3 stage 0
    assert calls[-1] == ("s0", 3, False)
    ex.interrupt()  # InterruptBA analog: current pass sees the flag
    ex.tick()  # kf 3 stage 1 (flagged)
    assert calls[-1] == ("s1", 3, True)
    assert done == [3]  # downstream fires at pass completion
    assert not m.interrupt_ba  # cleared between passes
    ex.tick()  # kf 4 stage 0, flag cleared
    assert calls[-1] == ("s0", 4, False)
    ex.flush()
    assert done == [3, 4] and ex.idle()
    # initial passes run synchronously, after draining the queue
    ex.submit(5)
    ex.submit(9, initial=True)
    assert ("init", 9) == calls[-1]
    assert done == [3, 4, 5, 9]
    # abort clears everything
    ex.submit(6)
    ex.tick()
    ex.abort()
    assert ex.idle() and done == [3, 4, 5, 9]
