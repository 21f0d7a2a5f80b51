"""Distributed utilities (port of `paddle_tpu/distributed/`): the
process-group launcher (`init_parallel_env`, `get_rank`,
`get_world_size`, `spawn`), the tensor-parallel layers
(`fleet.mpu`) and `fleet.utils.recompute`."""
from . import fleet
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .extras import spawn

__all__ = ["fleet", "ParallelEnv", "get_rank", "get_world_size",
           "init_parallel_env", "is_initialized", "spawn"]
