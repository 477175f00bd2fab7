"""Estimation backends (on-device, fully jitted).

Replaces the reference's L3 layer (filters/extended_kalman_filter.py,
filters/ekf_with_rotations.py) with a single fused MEKF engine:

* fixed-capacity landmark state with validity masks instead of dynamic
  ``np.hstack`` state growth (reference extended_kalman_filter.py:274),
* dense Cholesky innovation solve instead of SuperLU spsolve
  (reference extended_kalman_filter.py:129),
* trace-time AD measurement Jacobians instead of SymPy codegen + dill
  caching (reference ekf_with_rotations.py:347-424),
* one jitted step per frame, `lax.scan` over whole sequences.
"""

from aruco_slam_tpu.filters.mekf import (
    FrameObservations,
    MekfConfig,
    MekfState,
    init_state,
    innovation_gate,
    mekf_scan,
    mekf_step,
    rotation_consistency_gate,
)

__all__ = [
    "FrameObservations",
    "MekfConfig",
    "MekfState",
    "init_state",
    "innovation_gate",
    "mekf_scan",
    "mekf_step",
    "rotation_consistency_gate",
]
