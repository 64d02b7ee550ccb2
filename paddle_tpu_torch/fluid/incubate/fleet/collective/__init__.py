"""Collective fleet mode (counterpart ``paddle_tpu/fluid/incubate/fleet/
collective/__init__.py``; reference incubate/fleet/collective/__init__.py
:80 CollectiveOpBasedFleet / :215 CollectiveOptimizer).

``fleet.init(role)`` reads the rank's identity (``PaddleCloudRoleMaker``:
the launcher's ``PADDLE_*`` environment) and, in a world of more than one
rank, joins it (``fluid.distributed.init``: NCCL on the card; a script
that wants gloo calls ``fluid.distributed.init(backend="gloo")`` first).
``fleet.distributed_optimizer(opt).minimize(loss)`` is the optimizer's
minimize followed by the ``GradAllReduce`` (or ``LocalSGD``) transpile of
the program pair — the BERT-style synchronous path.  The chief (rank 0)
alone writes ``save_persistables`` and ``save_inference_model``, and every
rank waits for it at a barrier.

The strategy's ``weight_update_sharding``, ``allreduce_precision`` (with
``quant_block_size`` and ``error_feedback``) and
``use_hierarchical_allreduce`` (with ``hierarchical_allreduce_inter_nranks``,
the node count) go to the transpile, as in the JAX package.  Model
parallelism (``mp_degree``/``sp_degree``/``ep_degree`` > 1) is ROADMAP
queue 1 item 11 and raises naming it.
"""

from ..base.fleet_base import Fleet, DistributedOptimizer
from .... import distributed
from ....framework import default_startup_program
from ....transpiler.collective import GradAllReduce, LocalSGD


class DistributedStrategy:
    """The JAX package's strategy knobs; unknown keywords land in
    ``extras``."""

    def __init__(self, **kwargs):
        self.mp_degree = kwargs.pop("mp_degree", 1)
        self.sp_degree = kwargs.pop("sp_degree", 1)
        self.sp_mode = kwargs.pop("sp_mode", "ring")
        self.ep_degree = kwargs.pop("ep_degree", 1)
        self.ep_dispatch = kwargs.pop("ep_dispatch", "dense")
        self.local_sgd = kwargs.pop("local_sgd", False)
        self.local_sgd_steps = kwargs.pop("local_sgd_steps", 1)
        self.nrings = kwargs.pop("nrings", 1)
        # bucketed-allreduce threshold (reference fuse_all_reduce_ops +
        # fuse_grad_size_in_MB); 0 = one collective per grad
        self.fuse_grad_size_in_MB = kwargs.pop("fuse_grad_size_in_MB", 32)
        self.use_hierarchical_allreduce = kwargs.pop(
            "use_hierarchical_allreduce", False)
        self.hierarchical_allreduce_inter_nranks = kwargs.pop(
            "hierarchical_allreduce_inter_nranks", 0)
        self.use_bf16_allreduce = kwargs.pop("use_bf16_allreduce", False)
        self.allreduce_precision = kwargs.pop("allreduce_precision", None)
        self.quant_block_size = kwargs.pop("quant_block_size", None)
        self.error_feedback = kwargs.pop("error_feedback", True)
        self.weight_update_sharding = kwargs.pop("weight_update_sharding",
                                                 False)
        self.ep_dispatch_precision = kwargs.pop("ep_dispatch_precision",
                                                "fp32")
        self.extras = kwargs


class CollectiveFleet(Fleet):
    def init(self, role_maker=None):
        super().init(role_maker)
        if self.worker_num() > 1:
            distributed.init()

    def distributed_optimizer(self, optimizer, strategy=None):
        self._optimizer = CollectiveOptimizer(optimizer, strategy, self)
        return self._optimizer

    def minimize(self, loss, **kwargs):
        return self._optimizer.minimize(loss, **kwargs)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        from .... import io
        if distributed.is_chief():
            io.save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)
        distributed.barrier("fleet-save-inference-model")

    def save_persistables(self, executor, dirname, main_program=None):
        from .... import io
        if distributed.is_chief():
            io.save_persistables(executor, dirname, main_program)
        distributed.barrier("fleet-save-persistables")


class CollectiveOptimizer(DistributedOptimizer):
    """incubate/fleet/collective/__init__.py:215 — minimize, then
    transpile the program pair with GradAllReduce (or LocalSGD)."""

    def __init__(self, optimizer, strategy=None, fleet=None):
        super().__init__(optimizer, strategy or DistributedStrategy())
        self._fleet = fleet

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        strategy = self._strategy
        degrees = {k: getattr(strategy, k, 1)
                   for k in ("mp_degree", "sp_degree", "ep_degree")}
        if any(d > 1 for d in degrees.values()):
            raise NotImplementedError(
                "DistributedStrategy(%s): tensor, sequence and expert "
                "parallelism are not ported yet (ROADMAP queue 1 item 11)"
                % ", ".join("%s=%d" % kv for kv in sorted(degrees.items())
                            if kv[1] > 1))
        if getattr(strategy, "local_sgd", False):
            t = LocalSGD(nrings=strategy.nrings,
                         k_steps=strategy.local_sgd_steps)
        else:
            # built before minimize, so a bad option raises before the
            # program is touched
            t = GradAllReduce(
                nrings=getattr(strategy, "nrings", 1),
                fuse_grad_size_mb=getattr(strategy,
                                          "fuse_grad_size_in_MB", 32),
                use_bf16_allreduce=getattr(strategy,
                                           "use_bf16_allreduce", False),
                allreduce_precision=getattr(strategy,
                                            "allreduce_precision", None),
                quant_block_size=getattr(strategy, "quant_block_size",
                                         None),
                error_feedback=getattr(strategy, "error_feedback", True),
                weight_update_sharding=getattr(
                    strategy, "weight_update_sharding", False))
        optimize_ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        main = loss.block.program
        startup = startup_program or default_startup_program()
        fleet_obj = self._fleet or fleet
        init = fleet_obj._is_initialized
        rank = fleet_obj.worker_index() if init else 0
        nranks = fleet_obj.worker_num() if init else 0
        endpoints = fleet_obj.worker_endpoints() if init else []
        kwargs = {}
        if getattr(strategy, "use_hierarchical_allreduce", False) and \
                not getattr(strategy, "local_sgd", False):
            nnodes = getattr(strategy, "hierarchical_allreduce_inter_nranks",
                             0) or None
            if nnodes:
                kwargs["hierarchical_allreduce_nnodes"] = nnodes
        t.transpile(startup_program=startup, main_program=main, rank=rank,
                    endpoints=endpoints, nranks=nranks if endpoints else 0,
                    **kwargs)
        return optimize_ops, params_grads


fleet = CollectiveFleet()
