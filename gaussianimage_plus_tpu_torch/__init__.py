"""PyTorch + CUDA port of ``gaussianimage_plus_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference; each module here names the JAX
module and functions it ports. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; hand-written CUDA kernels live in ``csrc/``
and are built at first use. Nothing here imports JAX.
"""

from .core import precision  # noqa: F401  (sets the float32 policy on import)

__version__ = "0.1.0"
