"""Kernel-launch calls per capture in the traced window."""

from h100bench.readers import launches_per


def read(ctx):
    return launches_per(ctx, "capture")
