"""Vertex-index ↔ 24-bit RGB codec for ID rendering — a copy of
``dynamicfusion_body_tpu/utils/colorcodec.py`` (numpy only). Format parity
with the reference's core/colorutil.py:1-37: the rasterizer emits IDs
directly, and these functions keep interoperability with tooling that
expects color-ID images."""

from __future__ import annotations

import numpy as np


def idx2color(idx):
    return np.array(
        [idx // (256 * 256) % 256, idx // 256 % 256, idx % 256], dtype=np.uint8
    )


def image_color2idx(color_img, rgb=False):
    c = color_img.astype(np.int32)
    if rgb:
        return c[:, :, 2] * 65536 + c[:, :, 1] * 256 + c[:, :, 0]
    return c[:, :, 0] * 65536 + c[:, :, 1] * 256 + c[:, :, 2]


def image_int2color(int_img):
    out = np.zeros(int_img.shape + (3,), np.uint8)
    out[..., 0] = int_img // 65536 % 256
    out[..., 1] = int_img // 256 % 256
    out[..., 2] = int_img % 256
    return out


def distinct_colors(num_classes):
    return np.stack([idx2color(i + 1) for i in range(num_classes)])
