"""dynamicfusion_body_tpu_torch — the PyTorch/CUDA port of dynamicfusion_body_tpu.

The package mirrors the JAX package's module paths (``ops/``, ``models/``,
``solvers/``, ``pipeline/``) so each function's counterpart is found by
path. It imports ``torch`` and numpy, never ``jax``. Hand-written CUDA
kernels live in ``csrc/`` and are built with ``nvcc`` at first use
(``ops/cuda_lib.py``); every kernel has a plain PyTorch twin beside its
wrapper, which the wrapper uses only for CPU tensors.

Coordinate math runs in full float32: TF32 is switched off for matmuls
and cuDNN, the counterpart of the JAX package's rule that coordinate
matmuls run at ``Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .io.sdf_io import load_sdf  # noqa: E402,F401
from .pipeline.fusion import Fusion, FusionDM, FusionDM_GPU  # noqa: E402,F401
