"""K2 (the warp, trilerp and fusion of the non-rigid TSDF update) in the
traced frames: its bounds over its device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "frame", "k2", "warp_trilerp_cached_kernel")
