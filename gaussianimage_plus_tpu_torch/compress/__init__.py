"""Port of ``gaussianimage_plus_tpu.compress`` (see each module)."""
