"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's ``WarpField``, canonical-mesh dict, ``TsdfVolume`` and
``Fusion`` driver state, taken out as dicts of numpy arrays
(``{name: np.asarray(value)}``), become the port's tensors here, so both
packages can compute from one state.
Index arrays become int64, masks bool; the packed warp-selection slots
stay int32, as the K2 kernel reads them. The tensors go to the card
unless the caller asks for another device.

The DHBC network's Flax parameters, flattened to ``params/_Conv_{i}/
Conv_0/kernel|bias`` (the npz weights format), become the port module's
``state_dict`` (``convs.{i}.weight|bias``; HWIO kernels to OIHW) and back.
"""

from __future__ import annotations

import re

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
    "faces": torch.int32,
    "n_verts": torch.int32,
    "n_faces": torch.int32,
    "overflow": torch.bool,
    "brick_cand": torch.int64,
    "brick_risk": torch.int64,
    "warp_sel": torch.int32,
    "warp_selw": torch.float32,
    "warp_wi": torch.float32,
    "edge_axis": torch.int64,
    "edge_x": torch.int64,
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
    warp_selw/warp_wi caches and its lattice-edge identity (``edge_axis``,
    ``edge_x``) when present."""
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


_DHBC_FLAX = re.compile(r"params/_Conv_(\d+)/Conv_0/(kernel|bias)")
_DHBC_TORCH = re.compile(r"convs\.(\d+)\.(weight|bias)")


def dhbc_flax_key(key: str) -> str:
    """The Flax path of a DHBC ``state_dict`` key."""
    i, kind = _DHBC_TORCH.fullmatch(key).groups()
    return f"params/_Conv_{i}/Conv_0/{'kernel' if kind == 'weight' else 'bias'}"


def dhbc_state_from_flax(flat, device="cuda") -> dict:
    """The DHBC module's ``state_dict`` from Flax parameters flattened to
    ``{path: numpy array}`` (``flax.traverse_util.flatten_dict(params,
    sep="/")``, or an npz's arrays); entries that are not parameters (the
    npz markers) are skipped."""
    out = {}
    for k, v in flat.items():
        m = _DHBC_FLAX.fullmatch(k)
        if m is None:
            continue
        v = np.asarray(v, dtype=np.float32)
        if m.group(2) == "kernel":
            out[f"convs.{m.group(1)}.weight"] = _t(v.transpose(3, 2, 0, 1),
                                                  torch.float32, device)
        else:
            out[f"convs.{m.group(1)}.bias"] = _t(v, torch.float32, device)
    return out


def dhbc_state_to_flax(state) -> dict:
    """The inverse of :func:`dhbc_state_from_flax`: ``{Flax path: numpy
    array}`` with HWIO kernels."""
    out = {}
    for k, v in state.items():
        a = v.detach().cpu().numpy()
        out[dhbc_flax_key(k)] = (a.transpose(2, 3, 1, 0) if a.ndim == 4
                                 else a)
    return out
