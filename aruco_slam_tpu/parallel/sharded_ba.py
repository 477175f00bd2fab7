"""Distributed Schur-complement bundle adjustment.

SPMD decomposition (the north star's "partition keyframes and
landmark/map blocks ... all-reduce/reduce-scatter"), built on
one structural fact of marker SLAM: **every measurement factor touches
exactly one landmark**. Partitioning the factors BY LANDMARK SHARD
therefore makes the whole landmark side of the normal equations
device-local:

* landmarks (and their marginalization priors) are sharded over the
  mesh axis — each device owns a contiguous global slice,
* each device's factor shard contains exactly the factors observing
  its landmarks, with `f_lm` rewritten to shard-local indices, so the
  landmark blocks H_ll, the coupling columns W_:,j, and g_l are
  assembled exactly on-device with **zero communication**,
* the only collectives per LM iteration are small pose-sized psums:
  the measurement pose blocks (T·6·6 + T·6), the partial Schur
  complement S_partial = Σ_local W H_ll⁻¹ Wᵀ (T6 × T6), and the scalar
  cost. The reduced camera system solve is replicated (it is tiny by
  construction — that is the point of the Schur complement), and the
  landmark back-substitution is again local per shard.

Communication volume per iteration is O(T²) and independent of both
the landmark count and the factor count — the O(F + L) work is what
scales across devices. Compare the previous design (factor sharding
with a psum of the full (T,6,L,3) coupling tensor): that moved
O(T·L) floats per iteration; this moves none of it.

The sharded result is identical to the single-device
`graph.batch_optimize` up to float reduction order — asserted in
tests/test_parallel.py (f64, atol 1e-7).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aruco_slam_tpu.graph import ba
from aruco_slam_tpu.graph.ba import GraphConfig, GraphState


def _state_specs(axis: str) -> GraphState:
    """PartitionSpec pytree: poses replicated, landmarks + factors
    sharded over `axis`."""
    return GraphState(
        pose_q=P(), pose_t=P(), lm=P(axis), lm_q=P(axis),
        lm_active=P(axis), num_poses=P(), f_pose=P(axis),
        f_lm=P(axis), f_tcl=P(axis), f_qcl=P(axis), f_sig=P(axis),
        f_valid=P(axis), f_count=P(), prior_lm_h=P(axis),
        prior_lm_mean=P(axis))


def _shard_assignment(cfg: GraphConfig, state: GraphState, n: int):
    """(shard id per factor (-1 = invalid), landmarks per shard) —
    host-side values shared by capacity sizing and repartitioning (one
    device->host pull of the factor arrays, not two)."""
    lcap2 = -(-cfg.max_landmarks // n) * n
    lm_per = lcap2 // n
    f_lm = np.asarray(state.f_lm)
    f_valid = np.asarray(state.f_valid)
    return np.where(f_valid, f_lm // lm_per, -1), lm_per


def _shard_capacity(cfg: GraphConfig, state: GraphState, n: int,
                    shard=None) -> int:
    """Max factors any landmark shard holds, lane-aligned — the
    per-device factor capacity a balanced repartition needs."""
    if shard is None:
        shard, _ = _shard_assignment(cfg, state, n)
    counts = np.bincount(shard[shard >= 0], minlength=n)[:n]
    return max(-(-int(counts.max()) // 8) * 8, 8)


def partition_by_landmark(cfg: GraphConfig, state: GraphState, n: int,
                          f_shard: int | None = None
                          ) -> tuple[GraphConfig, GraphState]:
    """Host-side repartition: group factors by the landmark shard they
    observe and localize `f_lm`.

    Landmark capacity is padded to a multiple of `n`; device s owns
    global landmarks [s·L/n, (s+1)·L/n). Factors observing shard s are
    packed into the factor range [s·F̂, s·F̂ + count_s) where F̂ is the
    max per-shard count (lane-aligned); the rest is invalid padding.
    Landmark order is NOT permuted, so results slice back trivially.

    Runs on concrete (host) values — it is data-dependent layout work,
    done once per batch solve, outside jit.
    """
    lcap = cfg.max_landmarks
    lcap2 = -(-lcap // n) * n

    f_lm = np.asarray(state.f_lm)
    shard, lm_per = _shard_assignment(cfg, state, n)
    if f_shard is None:
        f_shard = _shard_capacity(cfg, state, n, shard=shard)
    f2 = f_shard * n

    dest = np.full(f_lm.shape[0], -1, np.int64)
    for s in range(n):
        idx = np.nonzero(shard == s)[0]
        dest[idx] = s * f_shard + np.arange(idx.shape[0])
    src = np.nonzero(dest >= 0)[0]
    d = dest[src]

    def scatter(arr, fill=0):
        a = np.asarray(arr)
        out = np.full((f2,) + a.shape[1:], fill, a.dtype)
        out[d] = a[src]
        return jnp.asarray(out)

    def pad_lm(arr):
        a = np.asarray(arr)
        pad = [(0, lcap2 - lcap)] + [(0, 0)] * (a.ndim - 1)
        return jnp.asarray(np.pad(a, pad))

    f_lm_local = scatter(f_lm - np.maximum(shard, 0) * lm_per)
    qcl = np.asarray(state.f_qcl)
    qcl_s = np.zeros((f2, 4), qcl.dtype)
    qcl_s[:, 0] = 1.0
    qcl_s[d] = qcl[src]
    lmq = np.asarray(state.lm_q)
    lmq_p = np.zeros((lcap2, 4), lmq.dtype)
    lmq_p[:, 0] = 1.0
    lmq_p[:lcap] = lmq
    cfg2 = cfg._replace(max_factors=f2, max_landmarks=lcap2)
    state2 = state._replace(
        lm=pad_lm(state.lm),
        lm_q=jnp.asarray(lmq_p),
        lm_active=pad_lm(state.lm_active),
        f_pose=scatter(state.f_pose),
        f_lm=f_lm_local,
        f_tcl=scatter(state.f_tcl),
        f_qcl=jnp.asarray(qcl_s),
        f_sig=scatter(state.f_sig, fill=float(cfg.meas_sigma_t)),
        f_valid=scatter(state.f_valid),
        prior_lm_h=pad_lm(state.prior_lm_h),
        prior_lm_mean=pad_lm(state.prior_lm_mean))
    return cfg2, state2


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4))
def _sharded_optimize(cfg: GraphConfig, state: GraphState, mesh: Mesh,
                      axis: str, iters: int, free_from):
    # full f32 matmul precision, same reasoning as graph.ba._optimize
    with jax.default_matmul_precision("highest"):
        return _sharded_optimize_impl(cfg, state, mesh, axis, iters,
                                      free_from)


def _lm_iterations(cfg: GraphConfig, lcfg: GraphConfig, axis: str,
                   st: GraphState, free_from, iters: int):
    """The per-device LM loop over one problem's shard view.

    `st` is this device's slice: full pose capacity (`cfg.max_poses`),
    local landmark/factor shards (`lcfg` capacities) — ba's kernels
    are written per-slice, so they apply verbatim to the shard. `axis`
    names the mesh axis the landmark shards live on; every psum here
    is over that axis only, so the loop composes with an outer vmap
    over a data-parallel fleet axis.
    """

    def cost_fn(s):
        shardable, odom = ba._cost_parts(lcfg, s)
        return jax.lax.psum(shardable, axis) + odom

    def step(carry, _):
        st, lam, cost = carry
        pose_free = ba.pose_free_mask(cfg, st, free_from)
        meas = ba._meas_terms(lcfg, st, pose_free)
        # pose-side partial sums -> replicated (the ONLY large
        # collective: O(T^2) + O(T), landmark-independent)
        diag, g_p, mcost = jax.lax.psum(
            (meas.diag, meas.g_p, meas.cost), axis)
        h_pp, g_p6, _ = ba._pose_system(
            cfg, st, pose_free,
            meas._replace(diag=diag, g_p=g_p, cost=mcost))
        # landmark side: exact on the local shard, no collective
        h_ll, g_l3, _ = ba._landmark_system(
            lcfg, st.lm, st.lm_active, st.prior_lm_h,
            st.prior_lm_mean, meas.h_ll, meas.g_l)
        w3 = meas.w4.reshape(cfg.max_poses * 6, -1, cfg.lm_dim)
        h_ll_inv, _, s_part, g_s_part = ba._schur_reduce(
            h_ll, w3, g_l3, lam)
        s_meas, g_s_meas = jax.lax.psum((s_part, g_s_part), axis)
        dp = ba._schur_pose_solve(h_pp, g_p6, s_meas, g_s_meas, lam)
        dl = ba._schur_back_substitute(h_ll_inv, w3, g_l3, dp)
        trial = ba._retract(st, dp.reshape(-1, 6), dl, free_from)
        new_cost = cost_fn(trial)
        accept = new_cost < cost
        st = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), trial, st)
        lam = jnp.where(accept, lam / cfg.lm_factor,
                        lam * cfg.lm_factor)
        lam = jnp.clip(lam, 1e-9, 1e6)
        cost = jnp.where(accept, new_cost, cost)
        return (st, lam, cost), None

    cost0 = cost_fn(st)
    # 0*cost0 ties lam0's varying-axes type to the shard data: under a
    # 2-D mesh the loop runs vmapped per 'data' shard with psums over
    # 'kf' only, so the carry varies over 'data' — a bare constant
    # would trip shard_map's varying-manual-axes check
    lam0 = jnp.asarray(cfg.lm_init_lambda, cfg.dtype) + 0.0 * cost0
    (st, _, cost), _ = jax.lax.scan(
        step, (st, lam0, cost0), None, length=iters)
    return st, cost


def _sharded_optimize_impl(cfg, state, mesh, axis, iters, free_from):
    n = mesh.shape[axis]
    lcfg = cfg._replace(max_factors=cfg.max_factors // n,
                        max_landmarks=cfg.max_landmarks // n)
    specs = _state_specs(axis)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(specs, P()),
                       out_specs=(specs, P()))
    def run(st: GraphState, free_from):
        return _lm_iterations(cfg, lcfg, axis, st, free_from, iters)

    return run(state, free_from)


def sharded_batch_optimize(cfg: GraphConfig, state: GraphState,
                           mesh: Mesh, iters: int = 50,
                           axis: str | None = None
                           ) -> tuple[GraphState, jnp.ndarray]:
    """Full-batch LM with landmark blocks AND factors sharded over
    `mesh`. Drop-in distributed counterpart of `graph.batch_optimize`:
    same inputs, same outputs (up to float reduction order).

    Multi-process safe: with a mesh spanning hosts (parallel/dist.py),
    every process passes the same `state` and gets fully-replicated
    (host-readable) results back — the landmark estimate is gathered
    once at the end, O(L) bytes total.
    """
    axis = axis or mesh.axis_names[0]
    n = mesh.shape[axis]
    cfg2, state2 = partition_by_landmark(cfg, state, n)
    state2 = jax.device_put(
        state2, jax.tree.map(
            lambda s: NamedSharding(mesh, s), _state_specs(axis),
            is_leaf=lambda x: isinstance(x, P)))
    out, cost = _sharded_optimize(cfg2, state2, mesh, axis, iters,
                                  jnp.asarray(1, jnp.int32))
    lcap = cfg.max_landmarks
    # poses/cost leave shard_map replicated already; the landmark shard
    # is gathered (and the pad sliced off) so hosts can read it
    lm, lm_q = jax.jit(lambda a, b: (a[:lcap], b[:lcap]),
                       out_shardings=NamedSharding(mesh, P()))(
        out.lm, out.lm_q)
    return state._replace(pose_q=out.pose_q, pose_t=out.pose_t,
                          lm=lm, lm_q=lm_q), cost


# ---------------------------------------------------------------------------
# 2-D mesh ('data', 'kf'): fleets of independent BA problems, each
# landmark-sharded — the full fabric shape (parallel/dist.make_mesh2d).
# ---------------------------------------------------------------------------

def stack_graphs(states: list[GraphState]) -> GraphState:
    """Stack same-capacity problems along a new leading fleet axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _fleet_specs(data_axis: str, kf_axis: str) -> GraphState:
    """PartitionSpecs for a stacked fleet: leading problem axis over
    `data_axis`, landmark/factor axes over `kf_axis`, poses
    replicated within each problem's kf group."""
    d, k = data_axis, kf_axis
    return GraphState(
        pose_q=P(d), pose_t=P(d), lm=P(d, k), lm_q=P(d, k),
        lm_active=P(d, k), num_poses=P(d), f_pose=P(d, k),
        f_lm=P(d, k), f_tcl=P(d, k), f_qcl=P(d, k), f_sig=P(d, k),
        f_valid=P(d, k), f_count=P(d), prior_lm_h=P(d, k),
        prior_lm_mean=P(d, k))


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
def _fleet_optimize(cfg: GraphConfig, states: GraphState, mesh: Mesh,
                    data_axis: str, kf_axis: str, iters: int):
    with jax.default_matmul_precision("highest"):
        n_kf = mesh.shape[kf_axis]
        lcfg = cfg._replace(max_factors=cfg.max_factors // n_kf,
                            max_landmarks=cfg.max_landmarks // n_kf)
        specs = _fleet_specs(data_axis, kf_axis)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(specs,),
                           out_specs=(specs, P(data_axis)))
        def run(st: GraphState):
            return jax.vmap(
                lambda s: _lm_iterations(
                    cfg, lcfg, kf_axis, s,
                    jnp.asarray(1, jnp.int32), iters))(st)

        return run(states)


def sharded_fleet_optimize(cfg: GraphConfig, states: GraphState,
                           mesh: Mesh, iters: int = 50,
                           data_axis: str = "data",
                           kf_axis: str = "kf"
                           ) -> tuple[GraphState, jnp.ndarray]:
    """Batch-LM a FLEET of independent BA problems on a 2-D mesh.

    ``states``: GraphState stacked on a leading fleet axis (see
    `stack_graphs`), one entry per sequence/survey; the fleet axis
    shards over `data_axis` (zero cross-problem traffic) and each
    problem's landmarks/factors shard over `kf_axis` (the psums of
    `_lm_iterations` ride only that inner axis — lay it on the
    devices of one host, `parallel/dist.make_mesh2d`). Returns (fleet
    states with replicated, host-readable pose/landmark estimates,
    per-problem final costs).
    """
    n_data = mesh.shape[data_axis]
    n_kf = mesh.shape[kf_axis]
    g = int(states.num_poses.shape[0])
    if g % n_data:
        raise ValueError(f"fleet size {g} not divisible by "
                         f"data axis {n_data}")
    problems = [jax.tree.map(lambda x: x[i], states) for i in range(g)]
    # one common per-shard factor capacity so the fleet stacks ragged-free
    f_shard = max(_shard_capacity(cfg, p, n_kf) for p in problems)
    parts = [partition_by_landmark(cfg, p, n_kf, f_shard=f_shard)
             for p in problems]
    cfg2 = parts[0][0]
    stacked = stack_graphs([s for _, s in parts])
    specs = _fleet_specs(data_axis, kf_axis)
    stacked = jax.device_put(
        stacked, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))
    out, cost = _fleet_optimize(cfg2, stacked, mesh, data_axis,
                                kf_axis, iters)
    lcap = cfg.max_landmarks
    rep = NamedSharding(mesh, P())
    out_host = jax.jit(
        lambda o, c: (o.pose_q, o.pose_t, o.lm[:, :lcap],
                      o.lm_q[:, :lcap], c),
        out_shardings=rep)(out, cost)
    pose_q, pose_t, lm, lm_q, cost = out_host
    return states._replace(pose_q=pose_q, pose_t=pose_t, lm=lm,
                           lm_q=lm_q), cost
