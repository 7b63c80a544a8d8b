"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's ``WarpField``, canonical-mesh dict, ``TsdfVolume`` and
``Fusion`` driver state, taken out as dicts of numpy arrays
(``{name: np.asarray(value)}``), become the port's tensors here, so both
packages can compute from one state.
Index arrays become int64, masks bool; the packed warp-selection slots
stay int32, as the K2 kernel reads them. The tensors go to the card
unless the caller asks for another device.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.tsdf_volume import TsdfVolume
from .models.warp_field import WarpField

_WF_FIELDS = ("node_pos", "node_dq", "node_w", "node_vert_idx", "active",
              "radius")
_MESH_DTYPES = {
    "verts": torch.float32,
    "normals": torch.float32,
    "values": torch.float32,
    "faces": torch.int64,
    "n_verts": torch.int64,
    "n_faces": torch.int64,
    "overflow": torch.bool,
    "brick_cand": torch.int64,
    "brick_risk": torch.int64,
    "warp_sel": torch.int32,
    "warp_selw": torch.float32,
    "warp_wi": torch.float32,
}


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def warp_field_from_jax(np_dict, device="cuda") -> WarpField:
    """WarpField from the JAX WarpField's fields as numpy arrays."""
    return WarpField(
        node_pos=_t(np_dict["node_pos"], torch.float32, device),
        node_dq=_t(np_dict["node_dq"], torch.float32, device),
        node_w=_t(np_dict["node_w"], torch.float32, device),
        node_vert_idx=_t(np_dict["node_vert_idx"], torch.int64, device),
        active=_t(np_dict["active"], torch.bool, device),
        radius=_t(np_dict["radius"], torch.float32, device),
    )


def warp_field_to_numpy(wf: WarpField) -> dict:
    """The port's WarpField as a dict of numpy arrays (JAX field names)."""
    return {f: getattr(wf, f).detach().cpu().numpy() for f in _WF_FIELDS}


def mesh_from_jax(np_dict, device="cuda") -> dict:
    """Canonical-mesh dict (``fusion_frame``'s ``canon_mesh``) from the JAX
    one as numpy arrays, with its brick_cand/brick_risk/warp_sel/
    warp_selw/warp_wi caches when present. The sharding-only entries
    (``edge_axis``, ``edge_x``) are dropped."""
    return {k: _t(v, _MESH_DTYPES[k], device) for k, v in np_dict.items()
            if k in _MESH_DTYPES}


def tsdf_volume_from_jax(np_dict, device="cuda") -> TsdfVolume:
    """TsdfVolume from the JAX TsdfVolume's ``values``, ``weights`` and
    ``ind`` as numpy arrays."""
    return TsdfVolume(
        values=_t(np_dict["values"], torch.float32, device),
        weights=_t(np_dict["weights"], torch.float32, device),
        ind=_t(np_dict["ind"], torch.float32, device),
    )


def load_fusion_state(fus, np_state) -> None:
    """Set a port ``Fusion``'s state from a JAX ``Fusion``'s as numpy
    arrays, on the port driver's device: ``values`` and ``weights`` (the
    canonical TSDF), ``warp`` (the WarpField's fields), ``lw``, ``mesh``
    (the canonical-mesh dict), ``nbr_idx`` and ``blend_wts``. The update
    caches are dropped (they are rebuilt from the new node set)."""
    dev = fus.device
    fus.volume = fus.volume.replace(
        values=_t(np_state["values"], torch.float32, dev),
        weights=_t(np_state["weights"], torch.float32, dev))
    fus._warp = warp_field_from_jax(np_state["warp"], device=dev)
    fus._lw = _t(np_state["lw"], torch.float32, dev)
    fus._mesh = mesh_from_jax(np_state["mesh"], device=dev)
    fus._nbr_idx = _t(np_state["nbr_idx"], torch.int64, dev)
    fus._blend_wts = _t(np_state["blend_wts"], torch.float32, dev)
    fus._upd_cache = None
