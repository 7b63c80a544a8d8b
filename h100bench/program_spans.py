"""What the span readers (``metrics/<name>.py`` with the source
``program_counter`` or ``program_span``) share: the program's own spans,
recorded in process by ``dynamicfusion_body_tpu_torch.utils.profiling.
RECORDER`` while the traced window's profiler ran. The warm-up runs before
that window and the check after it, untraced, so the recorder's totals
are the window's. A program without the recorder gives nothing to read."""

from __future__ import annotations


def recorder(ctx):
    """The program's recorder after a traced ingest run, or None (no
    trace, another unit, no recorder in the program, nothing recorded)."""
    if ctx.trace is None or ctx.unit != "capture" or not ctx.traced:
        return None
    try:
        from dynamicfusion_body_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    return RECORDER if RECORDER.counts else None


def ms_per_capture(ctx, path: str):
    """The host time of the spans at ``path`` over the traced captures,
    in ms; None where the window recorded no such span."""
    rec = recorder(ctx)
    if rec is None or path not in rec.counts:
        return None
    return rec.totals[path] * 1e3 / ctx.traced
