"""Multi-device decode: the batch split over a mesh of devices in one
process (`mesh.py`)."""

from .mesh import (make_mesh, shard_batch, sharded_decode,
                   sharded_pipeline_step)

__all__ = ["make_mesh", "shard_batch", "sharded_decode",
           "sharded_pipeline_step"]
