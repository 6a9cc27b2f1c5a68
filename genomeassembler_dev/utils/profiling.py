"""jax.profiler integration.

The reference's only tracing is wall-clock stage prints
(lib/DeNovoAssembler.R:52-56); StageTimer keeps that contract. This module
adds real device traces on top: wrap any region in `trace(logdir)` and load
the result in TensorBoard/XProf to see per-op device time, memory traffic
and fusion boundaries.
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed region."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def annotate(name: str):
    """Named sub-region within a trace (shows up in the trace viewer)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
