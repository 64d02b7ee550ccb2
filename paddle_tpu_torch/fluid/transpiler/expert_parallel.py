"""Expert parallel transpiler: MoE expert sharding as a program
annotation pass (counterpart ``paddle_tpu/fluid/transpiler/
expert_parallel.py``, the same pass op for op).

Every ``switch_moe`` op is stamped with ``ep_axis`` (and
``moe_dispatch``, ``moe_dispatch_precision``) and its expert weights
(``W1 [E, D, F]``, ``W2 [E, F, D]``) are recorded as sharded on the
expert dim (``program._mp_shardings``, axis ``ep``).  A rank's startup
keeps its ``E/ep`` experts and their optimizer state
(``fluid/model_parallel.py``); the op (``ops/moe_ops.py``) runs the dense
global formulation over the ep group, or with ``dispatch='a2a'`` the
GShard island: two all-to-alls of ``[E, C_local, D]`` slots at the wire
precision, with capacity per shard.

Usage::

    t = ExpertParallelTranspiler(ep_degree=2)
    t.transpile(main_program, startup_program)
    # or via fleet: DistributedStrategy(ep_degree=2)
"""


class ExpertParallelTranspiler:
    """Annotate a program's MoE ops + expert weights for expert
    parallelism over ``ep_degree`` mesh partitions."""

    def __init__(self, ep_degree, mesh_axis="ep", dispatch="dense",
                 dispatch_precision="fp32"):
        """``dispatch='a2a'`` stamps the GShard all-to-all island
        (moe_ops._switch_moe_a2a_island): two all-to-alls moving
        ~cf*N_local*D bytes per device instead of the dense
        formulation's global-token-count all-gather/all-reduce layout.
        Capacity becomes per-shard (token drops depend on local order);
        no-drop configurations are numerically identical to 'dense'.

        ``dispatch_precision`` ('fp32' | 'bf16' | 'int8') compresses the
        island's two all-to-all wires: tokens are activations, so int8
        quantizes each token row against its own max-abs scale with no
        error feedback (quantized_collectives.quantized_all_to_all).
        Only meaningful with ``dispatch='a2a'``."""
        from ..quantized_collectives import PRECISIONS
        if ep_degree < 1:
            raise ValueError("ep_degree must be >= 1")
        if dispatch not in ("dense", "a2a"):
            raise ValueError("dispatch must be 'dense' or 'a2a', got %r"
                             % (dispatch,))
        if dispatch_precision not in PRECISIONS:
            raise ValueError(
                "dispatch_precision must be one of %s, got %r"
                % (PRECISIONS, dispatch_precision))
        self.ep_degree = ep_degree
        self.mesh_axis = mesh_axis
        self.dispatch = dispatch
        self.dispatch_precision = dispatch_precision

    def transpile(self, main_program, startup_program=None):
        """Stamp every switch_moe op and shard its expert weights.
        Returns the list of annotated expert-weight names."""
        program = main_program
        ep = self.ep_degree
        shardings = getattr(program, "_mp_shardings", None)
        if shardings is None:
            shardings = program._mp_shardings = {}
        annotated = []
        for blk in program.blocks:
            for op in blk.ops:
                if op.type not in ("switch_moe", "switch_moe_grad"):
                    continue
                op.attrs["ep_axis"] = self.mesh_axis
                op.attrs["moe_dispatch"] = self.dispatch
                op.attrs["moe_dispatch_precision"] = self.dispatch_precision
                if op.type != "switch_moe":
                    continue
                for slot in ("W1", "W2"):
                    names = op.inputs.get(slot) or []
                    for n in names:
                        v = blk._find_var_recursive(n)
                        if v is None or not v.shape:
                            continue
                        E = v.shape[0]
                        if E is None or E % ep:
                            raise ValueError(
                                "num_experts=%s of %r is not divisible "
                                "by ep_degree=%d" % (E, n, ep))
                        if n not in shardings:
                            shardings[n] = (self.mesh_axis, 0)
                            annotated.append(n)
        if not annotated and not any(
                ax == self.mesh_axis for ax, _ in shardings.values()):
            raise ValueError(
                "ExpertParallelTranspiler found no switch_moe op to "
                "shard — build the model with fluid.layers.switch_moe")
        program._ep_degree = ep
        program._bump_version()
        if startup_program is not None:
            startup_program._ep_degree = ep
            startup_program._mp_shardings = dict(shardings)
        return annotated
