"""Batched and tile-sharded fitting on ``torch.distributed`` (port of
``gaussianimage_plus_tpu/parallel/__init__.py``; the same ``__all__``)."""

from .sharded import (
    batch_train_chunk,
    batch_train_chunk_dp,
    fit_batch,
    fit_image_tile_sharded,
    image_to_tile_rows,
    init_batch_train_state,
    make_mesh,
    make_tile_sharded_render,
    shard_batch,
)

__all__ = [
    "batch_train_chunk",
    "batch_train_chunk_dp",
    "fit_batch",
    "fit_image_tile_sharded",
    "image_to_tile_rows",
    "init_batch_train_state",
    "make_mesh",
    "make_tile_sharded_render",
    "shard_batch",
]
