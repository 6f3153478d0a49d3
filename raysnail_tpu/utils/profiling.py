"""Tracing / profiling helpers (reference has none — SURVEY.md sect.5): a
jax.profiler device trace + per-stage throughput counters."""

from __future__ import annotations

import contextlib
import logging
import time

import jax

log = logging.getLogger("raysnail")


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Capture a jax.profiler device trace viewable in TensorBoard/Perfetto.
    A profiler that fails to start raises: a run that asked for a trace
    must not carry on without one."""
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", trace_dir)


class Throughput:
    """Accumulates (rays, seconds) per named stage and reports Mrays/s."""

    def __init__(self):
        self.stages: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str, rays: int, block_on=None):
        t0 = time.time()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.time() - t0
        self.stages.setdefault(name, [0, 0.0])
        self.stages[name][0] += rays
        self.stages[name][1] += dt

    def report(self) -> dict:
        return {
            name: {"rays": r, "seconds": round(s, 4),
                   "mrays_per_s": round(r / max(s, 1e-9) / 1e6, 3)}
            for name, (r, s) in self.stages.items()
        }
