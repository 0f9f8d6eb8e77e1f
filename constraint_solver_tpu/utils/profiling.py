"""Profiling helpers (SURVEY.md §5 tracing/profiling).

The reference has no profiling at all (ad-hoc println only); here:

- ``trace(logdir)`` — context manager around ``jax.profiler`` capturing a
  device trace viewable in TensorBoard/Perfetto.  Degrades to a no-op with
  a warning when the backend can't profile.  A measurement that needs the
  trace must not use it: call ``jax.profiler`` directly so a failure
  raises.
- ``annotate(name)`` — named TraceAnnotation for host-side phases.
"""

from __future__ import annotations

import contextlib
import sys


@contextlib.contextmanager
def trace(logdir: str):
    import jax

    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception as e:  # noqa: BLE001 — backend may not support profiling
        print(f"[profiling] trace unavailable: {e}", file=sys.stderr)
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception as e:  # noqa: BLE001
                print(f"[profiling] stop_trace failed: {e}", file=sys.stderr)


def annotate(name: str):
    import jax

    return jax.profiler.TraceAnnotation(name)
