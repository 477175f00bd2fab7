"""Factor-graph backend: batched Gauss-Newton / Levenberg-Marquardt
bundle adjustment with dense Schur-complement elimination.

Replaces the reference's GTSAM stack (reference filters/factor_graph.py:
NonlinearFactorGraph + ISAM2 + LevenbergMarquardtOptimizer) with a
accelerator-shaped solver: fixed-capacity struct-of-arrays factor storage, all
residual/Jacobian blocks batched via vmap + jacfwd, normal equations
assembled as dense matmuls, landmark blocks eliminated by a dense Schur
complement, and the reduced camera system solved by Cholesky. The
ISAM2 role (incremental smoothing) is played by warm-started
sliding-window re-linearized Gauss-Newton; the batch LM role by the
same kernel over all poses.
"""

from aruco_slam_tpu.graph.ba import (
    GraphConfig,
    GraphState,
    add_frame,
    batch_optimize,
    init_graph,
    landmark_covariances,
    marginalize_poses,
    optimize_window,
)

__all__ = [
    "GraphConfig",
    "GraphState",
    "add_frame",
    "batch_optimize",
    "init_graph",
    "landmark_covariances",
    "marginalize_poses",
    "optimize_window",
]
