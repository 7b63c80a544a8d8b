"""Typed configuration of the fusion pipelines — a copy of
``dynamicfusion_body_tpu/config.py`` (the JAX package's ``__init__``
imports jax, so it is copied, not imported). A JSON file written by
either package's ``save_config`` loads in the other with equal fields.

Dataclasses that serialize to/from JSON and drive the CLI, in place of the
reference's constructor kwargs and in-source harness booleans (SURVEY
§5.6; test.py:16-21).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class CameraConfig:
    """Pinhole intrinsics — defaults are the reference harness camera
    (test.py:141)."""

    fx: float = 2000.0
    fy: float = 2000.0
    cx: float = 800.0
    cy: float = 600.0

    def matrix(self):
        import numpy as np

        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]],
            dtype=np.float32,
        )


@dataclass
class CapacityConfig:
    """Fixed-shape pool sizes (mesh buffers and the node pool)."""

    vert_cap: int = 1 << 16
    face_cap: int = 1 << 17
    node_cap: int = 2048


@dataclass
class FusionConfig:
    """Non-rigid pipeline hyperparameters (reference core/fusion.py:19-24,
    50 and solve kwargs at 327-333)."""

    trunc_distance: float = 0.2
    subsample_rate: float = 5.0
    knn: int = 4
    marching_cubes_step_size: int = 3
    tolerance: float = 0.2
    tukey_data_weight: float = 0.2
    huber_regularization_weight: float = 0.001
    regularization_weight: float = 1.0
    method: str = "clpts"  # or "cnn"
    use_cnn: bool = False
    write_warpfield: bool = True
    verbose: bool = False
    capacities: CapacityConfig = field(default_factory=CapacityConfig)

    # solver controls (no reference analogue — scipy internals)
    gn_iters: int = 8
    cg_iters: int = 32


@dataclass
class FusionDMConfig:
    """Multi-view rigid pipeline (reference core/fusion_dm.py:54-81)."""

    trunc_distance: float = 0.2
    tsdf_res: int = 256
    subsample_rate: float = 5.0
    knn: int = 4
    marching_cubes_step_size: int = 3
    use_auto_alignment: bool = False
    use_icp: bool = False
    verbose: bool = False
    camera: CameraConfig = field(default_factory=CameraConfig)
    capacities: CapacityConfig = field(
        default_factory=lambda: CapacityConfig(vert_cap=1 << 17, face_cap=1 << 18)
    )


def _to_dict(obj):
    return dataclasses.asdict(obj)


def save_config(cfg, path: str):
    with open(path, "w") as f:
        json.dump(_to_dict(cfg), f, indent=2)


def load_config(cls, path: str):
    with open(path) as f:
        data = json.load(f)
    return _from_dict(cls, data)


def _from_dict(cls, data):
    kwargs = {}
    for f_ in dataclasses.fields(cls):
        if f_.name not in data:
            continue
        v = data[f_.name]
        if dataclasses.is_dataclass(f_.type) or f_.name in (
            "camera", "capacities",
        ):
            sub = {"camera": CameraConfig, "capacities": CapacityConfig}[f_.name]
            kwargs[f_.name] = sub(**v)
        else:
            kwargs[f_.name] = v
    return cls(**kwargs)
