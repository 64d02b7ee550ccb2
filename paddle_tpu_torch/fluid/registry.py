"""Operator registry: one lowering rule per op type.

Each op registers ``fn(ctx, op)`` that reads its inputs from the
environment of torch tensors and writes its outputs back
(``lowering.LowerCtx``).  ``<type>_grad`` ops need no rule of their own:
``lowering.tape_grad_lower`` differentiates the forward rule's own
autograd graph, which the forward op recorded on the run's tape.
"""

OP_DEFS = {}


class OpDef:
    """Registered behavior for one op type."""

    def __init__(self, type, lower, nondiff_inputs=(), stop_gradient=False):
        self.type = type
        self.lower = lower
        # input slots that never receive gradient (integer labels, ids)
        self.nondiff_inputs = frozenset(nondiff_inputs)
        # op produces no differentiable outputs at all (random fills,
        # optimizer updates): backward.append_backward skips it
        self.stop_gradient = stop_gradient


def register_op(type, nondiff_inputs=(), stop_gradient=False):
    """Decorator: register ``fn(ctx, op)`` as the lowering for ``type``."""

    def deco(fn):
        OP_DEFS[type] = OpDef(type, fn, nondiff_inputs=nondiff_inputs,
                              stop_gradient=stop_gradient)
        return fn

    return deco


def get_op_def(type):
    if type not in OP_DEFS:
        raise NotImplementedError("No lowering registered for op %r" % type)
    return OP_DEFS[type]
