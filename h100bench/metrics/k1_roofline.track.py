"""K1 (marching cubes' case and crossing pass) in the traced frames: its
bounds over its device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "frame", "k1", "mc_case_cross_kernel")
