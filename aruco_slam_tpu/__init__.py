"""aruco_slam_tpu — an accelerator marker-SLAM engine in JAX/XLA.

A from-scratch re-design of the capabilities of the reference
OpenCV/GTSAM pipeline (supersimple33/aruco-slam):

  detect ArUco markers  ->  IPPE/PnP marker poses  ->  filter/smooth
  ->  trajectory + landmark map outputs

with an idiomatic batched, statically-shaped accelerator architecture
instead of a port (runs on NVIDIA GPUs; the CPU backend serves tests):

* ``core``     — quaternion / SO(3) / SE(3) / pinhole-camera math, pure JAX.
* ``ops``      — batched compute kernels: homography, IPPE-square PnP,
                 image-domain ArUco detection, ArUco dictionaries.
* ``filters``  — fused, jitted MEKF with fixed-capacity masked landmark
                 state (replaces filters/extended_kalman_filter.py and
                 filters/ekf_with_rotations.py of the reference).
* ``graph``    — batched Gauss-Newton / Levenberg-Marquardt bundle
                 adjustment with dense Schur-complement elimination of
                 landmark blocks (replaces GTSAM ISAM2 / LM in
                 filters/factor_graph.py of the reference).
* ``parallel`` — device meshes, sharded Schur BA, multi-sequence SLAM.
* ``io``       — trajectory (TUM), map persistence, calibration, frames.
* ``viz``      — host-side 2D overlay / 3D map rendering sinks.
* ``apps``     — CLI drivers (online SLAM, offline two-pass, calibrate).
* ``bench``    — synthetic scene generation, ATE/RPE, perf harnesses.
"""

__version__ = "0.1.0"
