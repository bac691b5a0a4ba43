"""Per-frame container + frustum/scale prediction kernels.

The reference `Frame` (`/root/reference/src/Frame.cc`) mixes data and
algorithms; here `FrameData` is a plain container (features come from
`ops/features.py`) and the algorithms (`isInFrustum` `Frame.cc:571`,
`MapPoint::PredictScale` `MapPoint.cc`) are batched jitted functions over
the whole map-point array at once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat
from orbslam3_jax.ops import lie


@dataclass
class FrameData:
    """One processed frame (host handle; arrays live on device)."""

    features: feat.Features
    timestamp: float
    frame_id: int
    R: np.ndarray  # (3,3) Tcw estimate (host copy for control logic)
    t: np.ndarray  # (3,)
    mp_assoc: np.ndarray  # (Nf,) int32 map-point id per feature (-1 none)
    ur: Optional[np.ndarray] = None  # (Nf,) stereo right-u
    depth: Optional[np.ndarray] = None  # (Nf,) stereo/RGB-D depth
    # Two-camera rig (stereo-fisheye): right-camera pixel of the matched
    # right feature per LEFT feature (for ToBody pose rows).
    uv_r: Optional[np.ndarray] = None  # (Nf,2)
    sig2_r: Optional[np.ndarray] = None  # (Nf,)
    has_r: Optional[np.ndarray] = None  # (Nf,) bool

    @property
    def n_features(self) -> int:
        return int(np.sum(np.asarray(self.features.valid)))

    def Twc(self):
        Rwc = self.R.T
        return Rwc, -Rwc @ self.t


@functools.partial(jax.jit, static_argnames=("model", "n_levels"))
def frustum_and_scale(
    model: cam.CameraModel,
    params: jnp.ndarray,
    R: jnp.ndarray,
    t: jnp.ndarray,
    mp_pos: jnp.ndarray,  # (P,3)
    mp_valid: jnp.ndarray,  # (P,)
    mp_normal: jnp.ndarray,  # (P,3)
    mp_min_dist: jnp.ndarray,
    mp_max_dist: jnp.ndarray,
    img_wh: jnp.ndarray,  # (2,)
    scale_factor: float = 1.2,
    n_levels: int = 8,
    view_cos_limit: float = 0.5,
):
    """Batched `Frame::isInFrustum` + `MapPoint::PredictScale`.

    Returns (uv (P,2), visible (P,), pred_octave (P,), view_cos (P,)).
    """
    Xc = lie.se3_apply(R, t, mp_pos)
    z = Xc[..., 2]
    uv = cam.project(model, params, Xc)
    Rwc = jnp.swapaxes(R, -1, -2)
    Ow = -Rwc @ t
    PO = mp_pos - Ow[None, :]
    dist = jnp.linalg.norm(PO, axis=-1)
    view_cos = jnp.sum(PO * mp_normal, axis=-1) / jnp.maximum(dist, 1e-9)
    in_img = (
        (uv[:, 0] >= 0)
        & (uv[:, 0] < img_wh[0])
        & (uv[:, 1] >= 0)
        & (uv[:, 1] < img_wh[1])
    )
    in_depth = (dist >= mp_min_dist * 0.8) & (dist <= mp_max_dist * 1.2)
    visible = mp_valid & (z > 0.1) & in_img & in_depth & (view_cos > view_cos_limit)
    # PredictScale: level = ceil(log(max_dist/dist)/log(scale))
    ratio = jnp.maximum(mp_max_dist, 1e-9) / jnp.maximum(dist, 1e-9)
    lvl = jnp.ceil(jnp.log(ratio) / np.log(scale_factor)).astype(jnp.int32)
    lvl = jnp.clip(lvl, 0, n_levels - 1)
    return uv, visible, lvl, view_cos


def search_radius(view_cos: jnp.ndarray, pred_octave: jnp.ndarray, scale_factor: float = 1.2):
    """Ref `Tracking::SearchLocalPoints` radius rule (`ORBmatcher.cc:RadiusByViewingCos`):
    2.5px if view_cos > 0.998 else 4.0px, scaled by the predicted octave."""
    base = jnp.where(view_cos > 0.998, 2.5, 4.0)
    return base * scale_factor**pred_octave.astype(jnp.float32)
