"""Data-parallel training and evaluation over torch.distributed, and each
frame's H axis split into bands over a space group (the port's
counterpart of tcvom_tpu/parallel/mesh.py)."""
from tcvom_tpu_torch.parallel import space
from tcvom_tpu_torch.parallel.ddp import (all_reduce_sum, all_reduce_sum_grad,
                                          backend, barrier, init_from_env,
                                          is_distributed, rank, shard_slice,
                                          world, wrap)
from tcvom_tpu_torch.parallel.space import (Bands, band_table, banded,
                                            space_group, whole)

__all__ = ["Bands", "all_reduce_sum", "all_reduce_sum_grad", "backend",
           "band_table", "banded", "barrier", "init_from_env",
           "is_distributed", "rank", "shard_slice", "space", "space_group",
           "whole", "world", "wrap"]
