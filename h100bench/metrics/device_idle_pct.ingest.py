"""The share of the traced ingest window with no device operation
running."""

from h100bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "capture")
