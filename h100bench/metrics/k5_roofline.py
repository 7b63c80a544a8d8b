"""K5 (multi-view projective fusion) in the traced captures: its bounds
over its device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "capture", "k5", "fuse_depth_multi_kernel")
