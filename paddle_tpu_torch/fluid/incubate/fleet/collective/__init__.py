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
parallelism (``mp_degree``/``sp_degree`` with ``sp_mode``/``ep_degree``
with ``ep_dispatch`` and ``ep_dispatch_precision``, > 1) applies the
tensor, sequence and expert transpilers instead; the rest of the world
is the data-parallel replicas (``fluid/model_parallel.py``).
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
        degrees = {k: getattr(strategy, k, 1) or 1
                   for k in ("mp_degree", "sp_degree", "ep_degree")}
        if any(d > 1 for d in degrees.values()):
            return self._minimize_model_parallel(
                loss, startup_program, parameter_list, no_grad_set, degrees)
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

    def _minimize_model_parallel(self, loss, startup_program,
                                 parameter_list, no_grad_set, degrees):
        """``mp/sp/ep_degree > 1`` (JAX collective/__init__.py:118-150):
        minimize, then the tensor, sequence and expert transpiles.  The
        ranks the degree leaves form the dp groups; with more than one
        replica the gradients are all-reduced over the dp group
        (``GradAllReduce`` on ring 0, which the model-parallel layer maps
        to the dp group), one by one: a sharded weight's gradient has the
        rank's shape, which a coalesced bucket of the program's shapes
        would not fit.  LocalSGD and hierarchical allreduce are refused,
        as in the JAX package, and so is a world the degrees do not
        divide."""
        strategy = self._strategy
        if getattr(strategy, "local_sgd", False) or \
                getattr(strategy, "use_hierarchical_allreduce", False):
            raise ValueError(
                "mp/sp/ep_degree>1 cannot be combined with local_sgd or "
                "use_hierarchical_allreduce")
        fleet_obj = self._fleet or fleet
        world = fleet_obj.worker_num() if fleet_obj._is_initialized \
            else distributed.process_count()
        degree = 1
        for d in degrees.values():
            degree *= max(int(d), 1)
        if world > 1 and world % degree:
            raise ValueError(
                "DistributedStrategy(%s) does not divide the world of %d "
                "rank(s)" % (", ".join("%s=%d" % kv for kv in
                                       sorted(degrees.items()) if kv[1] > 1),
                             world))
        from ....transpiler.expert_parallel import ExpertParallelTranspiler
        from ....transpiler.sequence_parallel import \
            SequenceParallelTranspiler
        from ....transpiler.tensor_parallel import TensorParallelTranspiler
        optimize_ops, params_grads = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        main = loss.block.program
        startup = startup_program or default_startup_program()
        if degrees["mp_degree"] > 1:
            TensorParallelTranspiler(degrees["mp_degree"]).transpile(
                main, startup)
        if degrees["sp_degree"] > 1:
            SequenceParallelTranspiler(
                degrees["sp_degree"],
                mode=getattr(strategy, "sp_mode", "ring")).transpile(
                    main, startup)
        if degrees["ep_degree"] > 1:
            ExpertParallelTranspiler(
                degrees["ep_degree"],
                dispatch=getattr(strategy, "ep_dispatch", "dense"),
                dispatch_precision=getattr(strategy,
                                           "ep_dispatch_precision",
                                           "fp32")).transpile(main, startup)
        if world // degree > 1:
            GradAllReduce(
                fuse_grad_size_mb=0,
                allreduce_precision=getattr(strategy,
                                            "allreduce_precision", None),
                use_bf16_allreduce=getattr(strategy,
                                           "use_bf16_allreduce", False)
            ).transpile(startup_program=startup, main_program=main,
                        rank=fleet_obj.worker_index()
                        if fleet_obj._is_initialized else 0,
                        endpoints=[], nranks=0)
        return optimize_ops, params_grads


fleet = CollectiveFleet()
