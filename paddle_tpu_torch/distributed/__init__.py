"""The multi-process runtime of the port (counterpart
``paddle_tpu/distributed``): the launcher (``python -m
paddle_tpu_torch.distributed.launch``) and ``init_parallel_env``.  The
parameter-server service (rpc, ps, communicator) is ROADMAP queue 1 item
13b.

Nothing is imported here eagerly: the launcher supervises its children
without importing torch."""


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, backend=None):
    """Join the world of ranks (``env.init_parallel_env``)."""
    from .env import init_parallel_env as init
    return init(coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id,
                backend=backend)
