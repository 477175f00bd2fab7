"""What every bench shares: the corners -> PnP -> fused-MEKF pipeline,
the timing helpers, the device peak table and the device fields of a
result row.

One definition of the hot path both `bench.py` (repo root) and
`bench/large_map.py` measure, so gating/chunking fixes cannot diverge
between them.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aruco_slam_tpu.filters import FrameObservations, mekf_scan
from aruco_slam_tpu.ops import pnp


def time_loop(fn, args, reps: int) -> float:
    """Seconds per call of ``fn(*args)``, with the repetitions ON
    DEVICE in one dispatch (host dispatch overhead stays out of the
    number). Every output leaf feeds the carry, so the whole program
    stays live, and each rep's inputs depend on the carry without
    changing value (the carry is never NaN for a finite program), so
    XLA cannot hoist the work out of the loop. The first call compiles
    and warms; the second is timed, ending in `block_until_ready`."""

    @jax.jit
    def loop(a):
        def body(_, acc):
            bump = jnp.isnan(acc)
            tied = jax.tree.map(
                lambda x: x ^ bump if x.dtype == jnp.bool_
                else x + bump.astype(x.dtype), a)
            out = fn(*tied)
            return acc + sum(jnp.sum(leaf.astype(jnp.float32))
                             for leaf in jax.tree.leaves(out))
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0))

    jax.block_until_ready(loop(args))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(loop(args))
    return (time.perf_counter() - t0) / reps


class Timed(NamedTuple):
    out: object          # the program's output (last timed call)
    compile_s: float     # lower + compile, seconds
    run_s: float         # seconds per call, steady state
    flops: float         # XLA cost-analysis FLOPs of one call
    memory: object       # compiled.memory_analysis()


def compile_and_time(fn, args, reps: int) -> Timed:
    """Compile ``fn(*args)`` ahead of time (one compilation serves the
    timing, the FLOP count and the memory analysis), warm it once,
    then time `reps` host-dispatched calls, each ending in
    `block_until_ready`. For programs of milliseconds and up; use
    `time_loop` where dispatch overhead would show."""
    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(exe(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(exe(*args))
    run_s = (time.perf_counter() - t0) / reps
    cost = exe.cost_analysis()
    if isinstance(cost, list):   # older JAX: one dict per device
        cost = cost[0]
    return Timed(out, compile_s, run_s, float(cost["flops"]),
                 exe.memory_analysis())


# Dense peak rates per JAX device, keyed by `device_kind`. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense (no
# sparsity) rates at the full 700 W power limit; a card set below it
# cannot hold its top clock under a matmul-heavy load, so report its
# power limit beside any share of these.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 data sheet (SXM, dense)",
    },
}


def device_peaks(kind: str | None = None) -> dict:
    """Peak table entry for `kind` (default: this process's first
    device). A device missing from the table is an error: there is no
    default peak to divide by."""
    kind = jax.devices()[0].device_kind if kind is None else kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no peak rates recorded for device kind "
                       f"{kind!r}; add it to bench/pipeline.PEAKS "
                       "with its source") from None


def device_fields() -> dict:
    """What every bench row names: platform, device kind and count."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": jax.device_count()}


def flops_of(fn, *args) -> float:
    """Static FLOP count of one jitted call, from XLA's compiled cost
    analysis — makes every bench's 'fast' auditable as achieved
    FLOP/s vs the device peak."""
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, list):   # older JAX: one dict per device
        cost = cost[0]
    return float(cost["flops"])


def flops_metrics(flops: float, seconds: float) -> dict:
    """{gflops_per_s, pct_of_tf32_peak} fields for a bench JSON row.
    The share is against the TF32 tensor-core peak: f32 matmuls at
    default precision run there, and "highest" runs slower still, so
    the share is a lower bound on how close the step gets. A CPU run
    has no device peak, so it reports the rate alone."""
    rate = flops / seconds
    out = {"gflops_per_s": round(rate / 1e9, 2)}
    if jax.devices()[0].platform != "cpu":
        out["pct_of_tf32_peak"] = round(
            100.0 * rate / device_peaks()["tf32_flops"], 3)
    return out


def make_pipeline(cam, marker_size: float, fcfg, chunk: int = 16,
                  reproj_gate: float = 3.0):
    """Returns pipeline(state, corners_seq (T,C,4,2), mask_seq (T,C))
    -> (final_state, trajectory (T,7)).

    The PnP solves are frame-independent so they run outside the
    sequential scan and fill the chip; `lax.map` chunks them over time
    so the solver intermediates stay bounded (vmapping a whole long
    sequence wants tens of GB at serving batch sizes). Frame counts
    that don't divide by `chunk` are zero-padded up to the next
    multiple (padded solves are discarded) — never serialized, so a
    prime T costs at most one extra chunk, not a 16x slowdown.
    """

    def pipeline(state, corners_seq, mask_seq):
        t = corners_seq.shape[0]
        ch = min(chunk, t)
        pad = (-t) % ch
        if pad:
            corners_seq = jnp.concatenate(
                [corners_seq,
                 jnp.zeros((pad,) + corners_seq.shape[1:],
                           corners_seq.dtype)])
        tp = t + pad

        def solve_chunk(c):
            res = pnp.solve_square_pnp(cam, c, marker_size)
            return res.t_cl, res.q_cl, res.err

        t_cl, q_cl, err = jax.lax.map(
            solve_chunk,
            corners_seq.reshape(tp // ch, ch, *corners_seq.shape[1:]))
        merge = lambda a: a.reshape(tp, *a.shape[2:])[:t]
        obs = FrameObservations(
            t_cl=merge(t_cl), q_cl=merge(q_cl),
            mask=mask_seq & (merge(err) < reproj_gate))
        return mekf_scan(fcfg, state, obs)

    return pipeline
