"""Host reads per traced capture: the ``host_read`` spans (each place the
host waits for the card: a device value read, a blocking copy from host
memory) under the program's ingest calls ``compute_live_tsdf`` and
``marching_cubes``."""

from h100bench.program_spans import recorder

ROOTS = ("compute_live_tsdf", "marching_cubes")


def read(ctx):
    rec = recorder(ctx)
    if rec is None or "compute_live_tsdf" not in rec.counts:
        return None
    return sum(n for path, n in rec.counts.items()
               if path.split("/")[0] in ROOTS
               and path.endswith("/host_read")) / ctx.traced
