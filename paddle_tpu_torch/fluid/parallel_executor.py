"""fluid.ParallelExecutor (counterpart ``paddle_tpu/fluid/
parallel_executor.py``; reference python/paddle/fluid/parallel_executor.py):
the reference's user API — construct with a loss name, call
``run(fetch_list, feed)`` — over ``CompiledProgram.with_data_parallel``
on this rank's device.
"""

from . import framework
from .compiler import CompiledProgram
from .executor import CPUPlace, CUDAPlace, Executor, global_scope

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .distributed import local_device_index
        self._program = main_program or framework.default_main_program()
        self._compiled = CompiledProgram(self._program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy,
            exec_strategy=exec_strategy,
            share_vars_from=getattr(share_vars_from, "_compiled", None))
        self._exe = Executor(CUDAPlace(local_device_index()) if use_cuda
                             else CPUPlace())
        self._use_cuda = bool(use_cuda)
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=fetch_list,
                             scope=self._scope or global_scope(),
                             return_numpy=return_numpy)

    @property
    def device_count(self):
        """The devices this rank drives (one process per rank: the
        launcher's ``--selected_devices``), not the world's."""
        from .mesh_utils import local_devices
        return len(local_devices(None if self._use_cuda else "cpu"))
