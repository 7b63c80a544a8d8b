"""Host time of the depth maps' copy to the card per traced capture: the
program's ``compute_live_tsdf/upload`` spans."""

from h100bench.program_spans import ms_per_capture


def read(ctx):
    return ms_per_capture(ctx, "compute_live_tsdf/upload")
