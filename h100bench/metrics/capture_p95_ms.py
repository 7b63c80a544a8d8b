"""The 95th percentile of every capture's time from the call to its
completion, over the window."""

import numpy as np


def read(ctx):
    return (float(np.percentile(ctx.latencies, 95)) * 1e3
            if ctx.unit == "capture" and ctx.latencies else None)
