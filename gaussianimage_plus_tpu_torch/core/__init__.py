"""Port of ``gaussianimage_plus_tpu.core`` (see each module)."""
