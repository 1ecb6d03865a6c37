"""Port of ``gaussianimage_plus_tpu.kernels`` (see each module)."""
