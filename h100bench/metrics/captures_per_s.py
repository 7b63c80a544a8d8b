"""Captures completed in the window over the window's wall time."""


def read(ctx):
    return ctx.n / ctx.window_s if ctx.unit == "capture" and ctx.n else None
