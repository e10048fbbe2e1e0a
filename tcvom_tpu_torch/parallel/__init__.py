"""Data-parallel training and evaluation over torch.distributed (the port's
counterpart of tcvom_tpu/parallel/mesh.py)."""
from tcvom_tpu_torch.parallel.ddp import (all_reduce_sum, all_reduce_sum_grad,
                                          backend, barrier, init_from_env,
                                          is_distributed, rank, shard_slice,
                                          world, wrap)

__all__ = ["all_reduce_sum", "all_reduce_sum_grad", "backend", "barrier",
           "init_from_env", "is_distributed", "rank", "shard_slice", "world",
           "wrap"]
