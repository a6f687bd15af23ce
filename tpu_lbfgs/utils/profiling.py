"""Device tracing helpers (SURVEY.md §5 tracing row).

The reference's only instrumentation is chrono wall-clock around the whole
solve plus per-iteration host prints that force a device sync
(benchmark.cpp:93-97, lbfgs.cpp:76-78).  Here:

  - per-iteration metrics come from the device-side Trace carried in the
    bounded scan (cfg.record_trace; types.Trace) — no syncs;
  - whole-solve device timelines come from ``jax.profiler`` via this
    module, viewable in TensorBoard/Perfetto (trace-viewer).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Record a jax.profiler trace of the enclosed block into ``trace_dir``
    (open with TensorBoard's profile plugin or ui.perfetto.dev).  A profiler
    that cannot start raises: a run asked to be traced never silently
    runs untraced."""
    with jax.profiler.trace(trace_dir):
        yield


def profile_solve(run_fn, *args, trace_dir: Optional[str] = None,
                  warmup: bool = True) -> dict:
    """Time (and optionally trace) one jitted solve, fenced by
    ``jax.block_until_ready`` on the whole result.
    Returns {"wall_s", "result", "trace_dir"}.
    """
    if warmup:
        jax.block_until_ready(run_fn(*args))
    ctx = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        out = jax.block_until_ready(run_fn(*args))
    return {"wall_s": time.perf_counter() - t0, "result": out,
            "trace_dir": trace_dir}
