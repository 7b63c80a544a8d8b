"""Host time of the ICP ingest's rigid solves per traced capture: the
program's ``rigid`` spans under ``compute_live_tsdf/icp`` (12
Gauss-Newton steps, 3 a view after the first)."""

from h100bench.program_spans import ms_per_capture


def read(ctx):
    return ms_per_capture(ctx, "compute_live_tsdf/icp/rigid")
