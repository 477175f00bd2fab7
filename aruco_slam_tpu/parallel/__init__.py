"""Multi-chip parallelism: device meshes, sharded Schur BA,
multi-sequence SLAM.

The reference has zero parallelism of any kind (SURVEY.md §2:
single-process, single-threaded, no threads/MPI/NCCL). This layer is
designed from scratch for SPMD: `jax.sharding.Mesh` + `shard_map`,
with XLA collectives (psum) over the device interconnect (NVLink/NCCL
between GPUs, Gloo between CPU processes).

* `sharded_ba` — distributed bundle adjustment: measurement-factor
  linearization sharded over the mesh, partial normal-equation terms
  reduced with psum, the small reduced camera system solved replicated
  (the Schur-complement partitioning of BASELINE.json's north star).
* `multi_slam` — batched parallel SLAM over many sequences (data
  parallel over a mesh axis): BASELINE.json config 5.
* `dist` — multi-process (multi-host) runtime init + the 2-D
  ('data', 'kf') mesh; `sharded_fleet_optimize` runs a fleet of BA
  problems over it (data-parallel outer, landmark-sharded inner).
"""

from aruco_slam_tpu.parallel.mesh import make_mesh
from aruco_slam_tpu.parallel.dist import (
    initialize, make_mesh2d, replicate_to_hosts)
from aruco_slam_tpu.parallel.sharded_ba import (
    sharded_batch_optimize, sharded_fleet_optimize, stack_graphs)
from aruco_slam_tpu.parallel.multi_slam import batched_mekf_scan

__all__ = ["make_mesh", "make_mesh2d", "initialize",
           "replicate_to_hosts", "sharded_batch_optimize",
           "sharded_fleet_optimize", "stack_graphs",
           "batched_mekf_scan"]
