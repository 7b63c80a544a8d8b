"""Kernel-launch calls per frame in the traced window."""

from h100bench.readers import launches_per


def read(ctx):
    return launches_per(ctx, "frame")
