"""Host time of the grid calibration per traced capture: the program's
``compute_live_tsdf/calibrate`` spans (the calibration, the fresh volume,
the per-view projections with their reads of the grid matrix)."""

from h100bench.program_spans import ms_per_capture


def read(ctx):
    return ms_per_capture(ctx, "compute_live_tsdf/calibrate")
