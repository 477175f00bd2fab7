"""Profiling / tracing helpers.

The reference has no profiling beyond tqdm progress bars (SURVEY.md
§5). Since frames/s per chip is a north-star metric, this module
provides: device-accurate stage timers (block_until_ready-based) and a
jax.profiler trace context for TensorBoard-compatible device traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class StageTimer:
    """Accumulating wall-clock timer that blocks on device results, so
    stage costs are real and not dispatch-async artifacts."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        yield out
        res = out.get("result", result)
        if res is not None:
            jax.block_until_ready(res)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get,
                           reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}s total "
                         f"{1e3 * t / max(n, 1):8.2f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """jax.profiler trace context (view with TensorBoard/XProf).

    A falsy logdir is a no-op, so call sites can write
    ``with device_trace(args.profile):`` unconditionally."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
