"""Port of ``gaussianimage_plus_tpu.utils`` (see each module)."""
