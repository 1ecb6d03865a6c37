"""Port of ``gaussianimage_plus_tpu.models`` (see each module)."""
