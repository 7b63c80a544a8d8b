"""Port of dynamicfusion_body_tpu/utils."""

from .colorcodec import (  # noqa: F401
    distinct_colors, idx2color, image_color2idx, image_int2color)
