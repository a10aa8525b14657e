"""Data parallelism over ``torch.distributed``: the data mesh, the
data-parallel ELBO and training step, and serving split over the ranks."""

from . import data_parallel, serving
from .data_parallel import (
    DataMesh,
    data_mesh,
    make_dp_elbo,
    make_dp_train_step,
    replicated,
    shard_batch,
)
from .serving import dp_predict_blocks

__all__ = [
    "DataMesh",
    "data_mesh",
    "shard_batch",
    "replicated",
    "make_dp_elbo",
    "make_dp_train_step",
    "dp_predict_blocks",
]
