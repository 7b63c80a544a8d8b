"""Host time of the ICP ingest's correspondences per traced capture: the
program's ``compute_live_tsdf/icp/correspondences`` spans (the live
marching cubes and the K7 search, 3 a view after the first)."""

from h100bench.program_spans import ms_per_capture


def read(ctx):
    return ms_per_capture(ctx, "compute_live_tsdf/icp/correspondences")
