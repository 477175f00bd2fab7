"""Multi-process (multi-host) runtime initialization + device meshes.

The reference is strictly single-process (reference main/run_slam.py:111
— a sequential frame loop; no multiprocessing/threads/MPI anywhere), so
this subsystem is designed from scratch for the multi-device shape:

* one Python process per host, driving every GPU of that host;
  `jax.distributed.initialize` wires the processes into one JAX
  runtime whose `jax.devices()` spans every device in the cluster,
* SPMD programs written once against a global `Mesh`; XLA compiles the
  collectives onto NCCL (NVLink within a host, the network across
  hosts) on GPUs and onto Gloo on the CPU backend — no NCCL/MPI calls
  in user code,
* a 2-D mesh ``('data', 'kf')``: independent SLAM sequences (map
  survey fleets, multi-camera rigs) are data-parallel over ``data``;
  within each sequence the bundle-adjustment landmark/factor blocks
  shard over ``kf`` (parallel/sharded_ba.py). Lay the ``kf`` axis
  innermost so its per-iteration psums stay within a host, with only
  the embarrassingly-parallel ``data`` axis crossing hosts.

The initialize() arguments are passed explicitly or via the
``SLAM_*`` env vars (nothing is autodetected); the multi-process CPU
test (tests/test_dist.py) exercises the same path over Gloo.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_devices: int | None = None) -> None:
    """Idempotent `jax.distributed.initialize` wrapper.

    Call once per process before any other JAX use. No-ops when the
    runtime is already initialized (so drivers can call it
    unconditionally). Missing arguments fall back to the env vars
    ``SLAM_COORDINATOR`` / ``SLAM_NUM_PROCESSES`` / ``SLAM_PROCESS_ID``.

    ``local_devices``: on the CPU backend, how many virtual devices
    this process contributes (sets
    ``--xla_force_host_platform_device_count``; must run before the
    backend initializes).
    """
    if jax.distributed.is_initialized():
        return
    if local_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count"
                f"={local_devices}").strip()
    coordinator_address = coordinator_address \
        or os.environ.get("SLAM_COORDINATOR")
    if num_processes is None and "SLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SLAM_NUM_PROCESSES"])
    if process_id is None and "SLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SLAM_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # a plain single-process run needs no distributed runtime
        return
    # cross-process collectives on the CPU backend need a transport;
    # Gloo is the in-tree one (GPUs use NCCL and ignore this knob)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def one_card_env(process_id: int, env: dict) -> dict:
    """Narrow a worker's environment to exactly one GPU.

    For a one-machine launch of several processes: a JAX process
    reserves most of the memory of every card it can see, so workers
    that each saw every card would fail. ``CUDA_VISIBLE_DEVICES`` (the
    caller's list if set, else cards 0, 1, ...) is narrowed to its
    ``process_id``-th entry; CPU-backend workers ignore it. Returns
    ``env``, updated in place."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible:
        cards = visible.split(",")
        if process_id >= len(cards):
            raise ValueError(
                f"process {process_id} has no card of its own: "
                f"CUDA_VISIBLE_DEVICES={visible!r}")
        env["CUDA_VISIBLE_DEVICES"] = cards[process_id]
    else:
        env["CUDA_VISIBLE_DEVICES"] = str(process_id)
    return env


def make_mesh2d(n_data: int | None = None, n_kf: int | None = None,
                devices=None) -> Mesh:
    """2-D ``('data', 'kf')`` mesh over the GLOBAL device list.

    ``kf`` is the fast-moving (innermost) axis so the BA psums stay on
    the chips with the tightest interconnect; ``data`` strides across
    hosts. Sizes default to: ``kf`` = all devices of one process (so a
    ``kf`` group never crosses a host), ``data`` = the rest.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if n_kf is None:
        n_kf = n // jax.process_count() if n_data is None \
            else n // n_data
    if n_data is None:
        n_data = n // n_kf if n_kf else 0
    if n_data < 1 or n_kf < 1 or n_data * n_kf > n:
        raise ValueError(
            f"make_mesh2d: {n_data}x{n_kf} mesh does not fit "
            f"{n} devices")
    if n_data * n_kf != n:
        print(f"make_mesh2d: {n_data}x{n_kf} uses "
              f"{n_data * n_kf}/{n} devices")
        devices = devices[: n_data * n_kf]
    arr = np.array(devices).reshape(n_data, n_kf)
    return Mesh(arr, ("data", "kf"))


def replicate_to_hosts(tree):
    """Make every leaf of a (possibly sharded) global-array pytree
    fully replicated, hence fully addressable on every process — the
    device→host boundary for multi-process results (trajectory/map
    writers run on process 0 against ordinary numpy arrays)."""
    leaves = jax.tree.leaves(tree)
    if not leaves or not isinstance(leaves[0], jax.Array):
        return tree
    sharding = leaves[0].sharding
    mesh = getattr(sharding, "mesh", None)
    if mesh is None:
        return tree
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    return jax.jit(lambda t: t,
                   out_shardings=jax.tree.map(lambda _: rep, tree))(tree)
