"""Host time of marching cubes per traced capture: the program's
``marching_cubes`` spans, from the call to the mesh on the card (the
first read of it waits for the fusion queued before it)."""

from h100bench.program_spans import ms_per_capture


def read(ctx):
    return ms_per_capture(ctx, "marching_cubes")
