"""CompiledProgram: data-parallel execution (counterpart
``paddle_tpu/fluid/compiler.py``; reference ``python/paddle/fluid/
compiler.py:48`` → ParallelExecutor).

In the JAX package one process drives every device: ``with_data_parallel``
shards the fed batch over a ``dp`` mesh axis and GSPMD inserts the
gradient all-reduces, so the program stays one logical step over the
global batch.  The port runs one process per rank (``fluid/distributed``,
``python -m paddle_tpu_torch.distributed.launch``): each rank feeds its
local batch and fetches its local rows, and ``with_data_parallel`` runs
a transpiled copy of the program —

- ``GradAllReduce`` (transpiler/collective.py): each gradient scaled by
  1/nranks and summed over the ranks, in 32 MB buckets
  (``BuildStrategy.fuse_all_reduce_ops``; off: one collective per
  gradient);
- every ``batch_norm`` as ``sync_batch_norm`` in a world of more than one
  rank, whatever ``BuildStrategy.sync_batch_norm`` says: under GSPMD the
  JAX package's batch_norm already normalises over the global batch, and
  a rank-local one would not match it.  In a world of one the knob
  decides;
- before its first step on a scope, the copy's startup part: the rings,
  and every parameter broadcast from rank 0 (the reference
  ParallelExecutor's BCastParamsToDevices), so the ranks start equal
  whatever their initializers drew.  The scope's step counter is kept.

With no process group (a world of one) the plain program runs.
Concatenating the ranks' fetches gives the JAX package's one fetch.
"""

import weakref

from . import distributed, framework
from .executor import _CompiledProgramProxy


class ReduceStrategy:
    AllReduce = 0
    Reduce = 1


class BuildStrategy:
    """details/build_strategy.h:36.  ``fuse_all_reduce_ops`` picks the
    bucketed gradient exchange (default) or one collective per gradient;
    ``sync_batch_norm`` turns batch_norm into sync_batch_norm in a world
    of one rank with a process group (a larger world always does, see
    the module docstring).  The other knobs are accepted for scripts
    that set them: the eager executor fuses nothing and frees each
    temporary after its last op.  ``zero_shard_optimizer_state`` (the
    JAX package's sharded optimizer state) is ROADMAP queue 1 item 10b."""

    ReduceStrategy = ReduceStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.sync_batch_norm = False
        self.zero_shard_optimizer_state = False


class ExecutionStrategy:
    """details/execution_strategy.h: scheduling knobs, accepted for
    scripts that set them (the executor runs one op at a time)."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class CompiledProgram(_CompiledProgramProxy):
    def __init__(self, program_or_graph):
        self._program = program_or_graph
        self._is_data_parallel = False
        self._places = None
        self._build_strategy = None
        self._exec_strategy = None
        self._loss_name = None
        self._dp = None           # (world key, main copy, startup copy)
        self._synced = weakref.WeakSet()   # scopes broadcast from rank 0

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        build_strategy = build_strategy or BuildStrategy()
        if getattr(build_strategy, "zero_shard_optimizer_state", False):
            raise NotImplementedError(
                "BuildStrategy.zero_shard_optimizer_state (sharded "
                "optimizer state) is not ported yet (ROADMAP queue 1 "
                "item 10b)")
        if places is not None and len(places) > 1:
            raise ValueError(
                "with_data_parallel(places=%r): the port runs one process "
                "per device; start one per card with python -m "
                "paddle_tpu_torch.distributed.launch (--selected_devices) "
                "and give each its own place" % (list(places),))
        self._is_data_parallel = True
        self._loss_name = loss_name
        self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._places = places
        return self

    def _target(self, exe, scope):
        """The program this rank runs: the plain one outside data
        parallel or without a process group, else the transpiled copy
        (built once per world), its parameters broadcast from rank 0
        into ``scope`` before the first step there."""
        dist = distributed._dist() if self._is_data_parallel else None
        if dist is None:
            return self._program
        key = (self._program.fingerprint, dist.get_world_size(),
               dist.get_rank())
        if self._dp is None or self._dp[0] != key:
            from .transpiler import GradAllReduce
            world = dist.get_world_size()
            bs = self._build_strategy
            main, startup = self._program.clone(), framework.Program()
            for p in main.global_block().all_parameters():
                # the broadcast writes the scope's parameters back only
                # if the startup copy declares them persistable
                startup.global_block().create_var(
                    name=p.name, shape=p.shape, dtype=p.dtype,
                    persistable=True)
            GradAllReduce(
                fuse_grad_size_mb=32 if bs.fuse_all_reduce_ops else 0,
                sync_batch_norm=world > 1 or bool(bs.sync_batch_norm),
            ).transpile(startup_program=startup, main_program=main,
                        rank=dist.get_rank(), endpoints=[], nranks=world)
            self._dp = (key, main, startup)
            self._synced = weakref.WeakSet()
        _key, main, startup = self._dp
        if scope not in self._synced:
            step = scope.step_counter
            exe.run(startup, scope=scope)
            scope.step_counter = step
            self._synced.add(scope)
        return main

    def _run(self, exe, feed, fetch_list, scope, return_numpy):
        program = self._target(exe, scope)
        if not feed and getattr(self._program, "_loader", None) is not None:
            return exe._loader_fed_run(
                self._program._loader,
                lambda f: exe._run_resolved(program, f, fetch_list, scope,
                                            return_numpy),
                lambda f, k: exe.run_window(program, feed=f,
                                            fetch_list=fetch_list,
                                            scope=scope, steps_per_run=k,
                                            return_numpy=False))
        return exe.run(program, feed=feed, fetch_list=fetch_list,
                       scope=scope, return_numpy=return_numpy)

    def _run_window(self, exe, feed, fetch_list, scope, steps_per_run,
                    return_numpy):
        """``Executor.run_window`` over the rank's program: the window's
        collectives are the K=1 step's, K times."""
        return exe.run_window(self._target(exe, scope), feed=feed,
                              fetch_list=fetch_list, scope=scope,
                              steps_per_run=steps_per_run,
                              return_numpy=return_numpy)
