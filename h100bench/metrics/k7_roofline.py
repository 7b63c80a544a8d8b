"""K7 (the ICP ingest's exact lattice k-NN, its query kernel) in the
traced captures: its bounds (``counts_icp.py``) over its device time."""

from h100bench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "capture", "k7", "knn_grid_query_kernel")
