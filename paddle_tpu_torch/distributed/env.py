"""``init_parallel_env``: the older entry point, an alias of
``paddle_tpu_torch.fluid.distributed.init`` (counterpart
``paddle_tpu/distributed/env.py``), so one training script runs as one
process or under the launcher unchanged."""

from ..fluid import distributed as _dist
from ..fluid.distributed import (  # noqa: F401
    parallel_env_from_env as _full_env,
    process_index, process_count, is_chief, barrier,
)


def parallel_env_from_env():
    """(coordinator, num_processes, process_id) from PADDLE_* env vars."""
    coord, nproc, rank, _local = _full_env()
    return coord, nproc, rank


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, backend=None):
    """Join the world of ranks (a no-op for one process); returns
    (process_id, num_processes).  See ``fluid.distributed.init``."""
    return _dist.init(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id,
                      backend=backend)
