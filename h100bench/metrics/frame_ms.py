"""The window's wall time over the frames it completed (the last frame
started in the window ends it)."""


def read(ctx):
    return ctx.window_s / ctx.n * 1e3 if ctx.unit == "frame" and ctx.n else None
