"""Structured stage timing (the reference's CTS:L<level>:S<step> spans).

The reference wraps every pipeline stage in ``linetimer.CodeTimer`` blocks
whose labels double as its telemetry vocabulary
(`BabelIntegrationBASE.py:997-1030`, SURVEY.md section 5). This module keeps
the same label convention so downstream log scrapers keep working, and adds
an in-process registry for programmatic access.
"""

from __future__ import annotations

import contextlib
import os
import time

_SPANS: list[tuple[str, float]] = []
_OPEN: list[str] = []  # tags of the spans currently running, outermost first


@contextlib.contextmanager
def stage_timer(label: str, level: int = 2, step: int | None = None, quiet=False):
    """Context manager emitting ``CTS:L<level>:S<step>: <label>`` timing.

    With ``BBT_PROFILE_DIR=<dir>`` set, each span additionally runs under a
    ``jax.profiler`` trace annotation (and the top-level span starts a
    profiler trace into that directory), so device timelines carry the same
    stage vocabulary as the logs — the equivalent of the reference's
    linetimer+telemetry span scheme (SURVEY.md section 5).
    """
    tag = f"CTS:L{level}" + (f":S{step}" if step is not None else "") + f": {label}"
    prof_dir = os.environ.get("BBT_PROFILE_DIR")
    ctx = contextlib.ExitStack()
    if prof_dir:
        try:
            import jax.profiler as jp

            if not _SPANS:  # outermost span starts the device trace
                ctx.enter_context(jp.trace(prof_dir))
            ctx.enter_context(jp.TraceAnnotation(tag))
        except Exception:
            pass  # profiling must never break the pipeline
    t0 = time.time()
    _OPEN.append(tag)
    try:
        with ctx:
            yield
    finally:
        _OPEN.pop()
        dt = time.time() - t0
        _SPANS.append((tag, dt))
        if not quiet:
            print(f"{tag} took {dt:.3f} s")
        try:
            from .telemetry import get_telemetry

            get_telemetry().event(tag, duration_s=dt)
        except Exception:
            pass  # telemetry must never break the pipeline


def recorded_spans():
    return list(_SPANS)


def open_spans():
    """Tags of the spans running now, outermost first."""
    return list(_OPEN)


def clear_spans():
    _SPANS.clear()
