"""orbslam3_jax — a visual-inertial SLAM engine written in JAX.

A from-scratch JAX/XLA/Pallas re-design of the full ORB-SLAM3 capability
surface (reference: /root/reference, ORB-SLAM3 V0.2-beta): monocular /
stereo / RGB-D tracking with pinhole + Kannala-Brandt fisheye cameras,
with and without IMU, Atlas multi-map, BoW place recognition, and a
Gauss-Newton/Levenberg-Marquardt optimization stack with block-Schur
elimination replacing g2o.

Unlike the reference (std::thread + mutexes on one host,
`src/System.cc:138-177`), state here lives in fixed-capacity
structure-of-arrays on device, every hot loop is a batched XLA (or Pallas)
program, and scaling is expressed with `jax.sharding` over a device mesh.
"""

__version__ = "0.1.0"

from orbslam3_jax import ops  # noqa: F401
