"""What the metric readers (``metrics/<name>.py``) share. Each reader is
``read(ctx) -> float | None``; None leaves the metric out of the line.
``ctx`` holds the run: ``unit`` (what a request is), ``n`` requests in
the window of ``window_s`` seconds with their ``latencies``, ``setup_s``;
after a traced run also ``trace`` (``trace.summarize``), ``traced`` (the
requests in the traced window) and ``bounds`` ({kernel: [the bound of
each of its launches in the traced window, ms]})."""

from __future__ import annotations


def idle_pct(ctx, unit: str):
    """The share of the traced window in which no device operation ran."""
    if ctx.trace is None or ctx.unit != unit or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def launches_per(ctx, unit: str):
    """Kernel-launch calls in the traced window over its requests."""
    if ctx.trace is None or ctx.unit != unit or not ctx.traced:
        return None
    return ctx.trace["launches"] / ctx.traced


def roofline_pct(ctx, unit: str, key: str, kernel: str):
    """The kernel's bounds over its device time in the traced window, as
    a percentage; None where the trace holds another number of its
    launches than the bounds count (a lost record) or none."""
    if ctx.trace is None or ctx.unit != unit:
        return None
    bounds = ctx.bounds.get(key, [])
    times = [t for name, ts in ctx.trace["kernels"].items()
             if kernel in name for t in ts]
    if not bounds or len(times) != len(bounds) or sum(times) <= 0:
        return None
    return 100.0 * (sum(bounds) * 1e-3) / sum(times)
