"""Full pipeline checkpoint / resume — counterpart of
``dynamicfusion_body_tpu/io/checkpoint.py``.

The complete per-frame state (canonical TSDF values, weights and IND, the
warp-field pool, the global pose and the frame counter) round-trips
through one compressed npz in the JAX package's format version 1: the
same keys and dtypes (``node_vert_idx`` int32, as the JAX package keeps
it), so either package reads the other's files. The reference only
pickled the node list (``io/warpfield_io.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import tsdf_volume_from_jax, warp_field_from_jax

FORMAT_VERSION = 1
_WF_DTYPES = {"node_pos": np.float32, "node_dq": np.float32,
              "node_w": np.float32, "node_vert_idx": np.int32,
              "active": np.bool_, "radius": np.float32}


def _np(t, dtype=np.float32):
    return np.asarray(torch.as_tensor(t).detach().cpu().numpy(), dtype=dtype)


def save_checkpoint(path, volume, wf, lw_dq, itercounter: int = 0,
                    extra: dict | None = None):
    """Write the full fusion state (a ``TsdfVolume``, a ``WarpField``, the
    (8,) pose) to ``path`` (npz, compressed)."""
    data = {
        "format_version": FORMAT_VERSION,
        "tsdf_values": _np(volume.values),
        "tsdf_weights": _np(volume.weights),
        "ind": _np(volume.ind),
        **{f: _np(getattr(wf, f), dt) for f, dt in _WF_DTYPES.items()},
        "lw_dq": _np(lw_dq),
        "itercounter": itercounter,
    }
    for k, v in (extra or {}).items():
        data["extra_" + k] = np.asarray(v)
    np.savez_compressed(path, **data)


def load_checkpoint(path, device="cuda"):
    """Returns (volume, warp_field, lw_dq, itercounter, extra), the tensors
    on ``device``."""
    with np.load(path) as z:
        if int(z["format_version"]) != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {int(z['format_version'])}")
        volume = tsdf_volume_from_jax(
            {"values": z["tsdf_values"], "weights": z["tsdf_weights"],
             "ind": z["ind"]}, device=device)
        wf = warp_field_from_jax({f: z[f] for f in _WF_DTYPES},
                                 device=device)
        lw = torch.as_tensor(z["lw_dq"], device=device)
        it = int(z["itercounter"])
        extra = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return volume, wf, lw, it, extra
