"""Cells cut to a size the CPU runs in seconds, for the tests: the
tracking scene scaled to 32³ (spheres, caps and node pool with the
lattice, as the port's own tools scale the 256³ bench scene), the ingest
at 32³ with 64² views and a pool of 2 captures."""

from __future__ import annotations

import copy

from h100bench import manifest


def _cap(base: int, res: int, full: int, floor: int) -> int:
    return max(base * res * res // (full * full), floor)


def small_cell(name: str, res: int = 32):
    cell = manifest.cell(name, manifest.load(deferred=True))
    cfg = copy.deepcopy(cell.config)
    full = cfg["res"]
    s = res / full
    cfg["res"] = res
    if cfg["entry"] == "fusion_frame":
        sph = cfg["sphere"]
        for k in ("canonical_center", "live_center"):
            sph[k] = [c * s for c in sph[k]]
        sph["radius"] *= s
        sph["amp"] *= s
        caps = cfg["caps"]
        caps["vert_cap"] = _cap(caps["vert_cap"], res, full, 2048)
        caps["face_cap"] = _cap(caps["face_cap"], res, full, 4096)
        caps["live_vert_cap"] = _cap(caps["live_vert_cap"], res, full, 2048)
        caps["live_face_cap"] = _cap(caps["live_face_cap"], res, full, 4096)
        ic = cfg["init_canonical"]
        ic["node_cap"] = _cap(ic["node_cap"], res, full, 256)
        cfg["frame"]["gn_iters"] = 4
        cfg["frame"]["cg_iters"] = 8
        cfg["warmup_frames"] = 1
    else:
        cfg["cameras"] = dict(cfg["cameras"], img=64, f=50.0)
        cfg["caps"] = {"vert_cap": 1 << 14, "face_cap": 1 << 15}
        cfg["warmup_captures"] = 1
        cell.traffic = dict(cell.traffic, pool=2, sweep_captures=2)
    cell.config = cfg
    return cell
