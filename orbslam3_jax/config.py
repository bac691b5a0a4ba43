"""Typed settings with reference-compatible YAML ingestion.

The reference reads per-dataset YAML via cv::FileStorage at Tracking
construction (`/root/reference/src/Tracking.cc:57-343`: `Camera.type`,
`Camera.fx..k4`, `Camera.bf/fps/RGB`, `ThDepth`, `DepthMapFactor`,
`ORBextractor.*`, `Tbc`, `IMU.*`, plus a second camera + `Tlr` for
stereo-fisheye). This module parses those exact keys into dataclasses so
the reference's YAML files work unmodified (they start with `%YAML:1.0`
and use OpenCV matrix nodes, both handled here).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from orbslam3_jax.ops import cameras as cam
from orbslam3_jax.ops import features as feat


@dataclass
class CameraConfig:
    model: cam.CameraModel
    params: np.ndarray  # length-8 vector (see ops/cameras.py)
    width: int
    height: int
    fps: float = 30.0
    bf: float = 0.0  # baseline * fx (stereo / RGB-D)
    th_depth: float = 35.0  # close/far stereo point threshold (ThDepth)
    rgb: bool = True
    # second camera (stereo fisheye)
    params2: Optional[np.ndarray] = None
    T_c1_c2: Optional[np.ndarray] = None  # 4x4 (Tlr)
    lapping1: Optional[tuple] = None  # (lappingBegin, lappingEnd) cam 1
    lapping2: Optional[tuple] = None
    depth_map_factor: float = 1.0


@dataclass
class RectifyConfig:
    """One side of the reference's stereo-rectification block
    (`LEFT./RIGHT. K/D/R/P` + height/width, `Tracking.cc:299-323`)."""

    K: np.ndarray  # (3,3) original intrinsics
    D: np.ndarray  # (4-5,) radtan distortion
    R: np.ndarray  # (3,3) rectifying rotation
    P: np.ndarray  # (3,4) rectified projection
    width: int
    height: int


@dataclass
class ImuConfig:
    Tbc: np.ndarray  # 4x4 body<-camera
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    freq: float


@dataclass
class Settings:
    camera: CameraConfig
    orb: feat.OrbParams
    imu: Optional[ImuConfig] = None
    # Raw-stereo rectification (LEFT./RIGHT. blocks); None = pre-rectified.
    rect_left: Optional[RectifyConfig] = None
    rect_right: Optional[RectifyConfig] = None


def _load_opencv_yaml(path: str) -> dict:
    """cv::FileStorage YAML: strip the `%YAML:1.0` directive and map
    `!!opencv-matrix` nodes to plain dicts. Needs PyYAML (the
    `datasets` extra)."""
    import yaml

    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML:[\d.]+", "", text.strip())
    text = text.replace("!!opencv-matrix", "")
    # cv::FileStorage accepts `Key:value` without a space; YAML does not.
    text = re.sub(r"^([A-Za-z0-9_.]+):(?=\S)", r"\1: ", text, flags=re.M)
    return yaml.safe_load(text)


def _get_matrix(node) -> np.ndarray:
    if isinstance(node, dict) and "data" in node:
        return np.asarray(node["data"], np.float64).reshape(
            int(node["rows"]), int(node["cols"])
        )
    return np.asarray(node, np.float64)


def load_settings(path: str) -> Settings:
    """Parse a reference-format YAML (EuRoC.yaml, TUM_512.yaml, ...)."""
    d = _load_opencv_yaml(path)

    cam_type = d.get("Camera.type", "PinHole")
    fx, fy = float(d["Camera.fx"]), float(d["Camera.fy"])
    cx, cy = float(d["Camera.cx"]), float(d["Camera.cy"])
    if cam_type in ("PinHole", "Rectified"):
        model = cam.CameraModel.PINHOLE
        params = np.asarray(
            [fx, fy, cx, cy,
             float(d.get("Camera.k1", 0.0)), float(d.get("Camera.k2", 0.0)),
             float(d.get("Camera.p1", 0.0)), float(d.get("Camera.p2", 0.0))],
            np.float32,
        )
    elif cam_type == "KannalaBrandt8":
        model = cam.CameraModel.KB8
        params = np.asarray(
            [fx, fy, cx, cy,
             float(d["Camera.k1"]), float(d["Camera.k2"]),
             float(d["Camera.k3"]), float(d["Camera.k4"])],
            np.float32,
        )
    else:
        raise ValueError(f"unknown Camera.type {cam_type}")

    params2 = None
    T12 = None
    if "Camera2.fx" in d:
        params2 = np.asarray(
            [float(d["Camera2.fx"]), float(d["Camera2.fy"]),
             float(d["Camera2.cx"]), float(d["Camera2.cy"]),
             float(d.get("Camera2.k1", 0.0)), float(d.get("Camera2.k2", 0.0)),
             float(d.get("Camera2.k3", 0.0)), float(d.get("Camera2.k4", 0.0))],
            np.float32,
        )
        if "Tlr" in d:
            T12 = _get_matrix(d["Tlr"])

    def _lap(prefix):
        if f"{prefix}.lappingBegin" in d:
            return (float(d[f"{prefix}.lappingBegin"]),
                    float(d[f"{prefix}.lappingEnd"]))
        return None

    camera = CameraConfig(
        model=model,
        params=params,
        width=int(d.get("Camera.width", 752)),
        height=int(d.get("Camera.height", 480)),
        fps=float(d.get("Camera.fps", 30.0)),
        bf=float(d.get("Camera.bf", 0.0)),
        th_depth=float(d.get("ThDepth", 35.0)),
        rgb=bool(int(d.get("Camera.RGB", 1))),
        params2=params2,
        T_c1_c2=T12,
        lapping1=_lap("Camera"),
        lapping2=_lap("Camera2"),
        depth_map_factor=float(d.get("DepthMapFactor", 1.0)),
    )
    orb = feat.OrbParams(
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        ini_th=float(d.get("ORBextractor.iniThFAST", 20)),
        min_th=float(d.get("ORBextractor.minThFAST", 7)),
    )
    def _rect(prefix):
        if f"{prefix}.K" not in d:
            return None
        return RectifyConfig(
            K=_get_matrix(d[f"{prefix}.K"]),
            D=_get_matrix(d[f"{prefix}.D"]).reshape(-1),
            R=_get_matrix(d[f"{prefix}.R"]),
            P=_get_matrix(d[f"{prefix}.P"]),
            width=int(d.get(f"{prefix}.width", camera.width)),
            height=int(d.get(f"{prefix}.height", camera.height)),
        )

    rect_left = _rect("LEFT")
    rect_right = _rect("RIGHT")

    imu = None
    if "IMU.NoiseGyro" in d:
        Tbc = _get_matrix(d["Tbc"]) if "Tbc" in d else np.eye(4)
        imu = ImuConfig(
            Tbc=Tbc,
            noise_gyro=float(d["IMU.NoiseGyro"]),
            noise_acc=float(d["IMU.NoiseAcc"]),
            walk_gyro=float(d["IMU.GyroWalk"]),
            walk_acc=float(d["IMU.AccWalk"]),
            freq=float(d.get("IMU.Frequency", 200.0)),
        )
    return Settings(camera=camera, orb=orb, imu=imu,
                    rect_left=rect_left, rect_right=rect_right)
