"""Port of ``gaussianimage_plus_tpu.kernels`` (see each module)."""


def wrappers() -> tuple:
    """The six kernel wrappers, A to F; each counts its launches in its
    ``launches`` attribute."""
    from . import binning_tiles, raster_binned, raster_list

    return (raster_binned.tile_table_forward, raster_list.chunk_list_forward,
            raster_list.chunk_backward, raster_binned.tile_table_backward,
            binning_tiles.tile_bin, raster_list.chunk_lists)
