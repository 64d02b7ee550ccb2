"""Declarative autodiff: append gradient ops to the program (counterpart
``paddle_tpu/fluid/backward.py``; reference ``python/paddle/fluid/
backward.py:432`` append_backward).

Walk the block's ops in reverse, emit a ``<type>_grad`` op per forward op
that receives a gradient, insert ``sum`` ops where a variable's gradient
has several contributions, and return (param, grad) pairs.  The op types,
``@GRAD`` names, loss seed (``fill_constant``) and ``sum`` accumulation
are the JAX package's, so both packages build the same program.  The
grad kernel is derived: ``lowering.tape_grad_lower`` differentiates the
autograd graph the forward op recorded on the run's tape.
"""

from .framework import (OpRole, OP_ROLE_KEY, OP_ROLE_VAR_KEY, Parameter,
                        grad_var_name)
from .data_types import is_floating
from .registry import OP_DEFS


def _find_loss_op_idx(block, loss):
    for i in reversed(range(len(block.ops))):
        if loss.name in block.ops[i].output_arg_names():
            return i
    raise ValueError("loss variable %r is not produced by any op" % loss.name)


def _create_grad_var(block, name, ref_var=None):
    if block.has_var_local(name):
        return block.vars[name]
    kwargs = {}
    if ref_var is not None:
        kwargs = dict(shape=ref_var.shape, dtype=ref_var.dtype)
    return block.create_var(name=name, **kwargs)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append grad ops for every op contributing to ``loss``.

    Returns a list of (Parameter, grad Variable) pairs for trainable params,
    ordered as the parameters appear in the program (backward.py:432 contract).
    """
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    with program._role_guard(OpRole.Backward):
        loss_idx = _find_loss_op_idx(block, loss)
        loss_grad_name = grad_var_name(loss.name)
        _create_grad_var(block, loss_grad_name, loss)
        block.append_op(
            "fill_constant",
            outputs={"Out": [loss_grad_name]},
            attrs={"shape": [1], "value": 1.0, "dtype": loss.dtype,
                   OP_ROLE_KEY: OpRole.Backward | OpRole.Loss})

        # var name -> list of grad var names contributing to it
        grad_contribs = {loss.name: [loss_grad_name]}
        # var name -> finalized grad var name
        grad_of = {}

        def resolve_output_grad(var_name):
            """Collapse accumulated contributions into one grad var,
            inserting a ``sum`` op when there are several (the reference's
            _addup_repetitive_outputs_)."""
            if var_name in grad_of:
                return grad_of[var_name]
            contribs = grad_contribs.get(var_name)
            if not contribs:
                return None
            if len(contribs) == 1:
                grad_of[var_name] = contribs[0]
                return contribs[0]
            target = grad_var_name(var_name)
            if any(c == target for c in contribs):
                # canonical name already used by one contribution; sum into a
                # fresh var to avoid a false self-dependency
                target = target + "@SUM"
            _create_grad_var(block, target, block._find_var_recursive(var_name))
            block.append_op("sum", inputs={"X": contribs},
                            outputs={"Out": [target]})
            grad_of[var_name] = target
            return target

        def new_input_grad_name(var_name):
            base = grad_var_name(var_name)
            contribs = grad_contribs.setdefault(var_name, [])
            name = base if not contribs else "%s@RENAME@%d" % (base,
                                                               len(contribs))
            contribs.append(name)
            _create_grad_var(block, name, block._find_var_recursive(var_name))
            return name

        for op in reversed(block.ops[:loss_idx + 1]):
            opdef = OP_DEFS.get(op.type)
            if opdef is not None and opdef.stop_gradient:
                continue
            if op.attr(OP_ROLE_KEY, OpRole.Forward) & OpRole.Optimize:
                continue

            # does any output of this op receive a gradient?
            out_grad_slots = {}
            any_grad = False
            for slot, names in op.outputs.items():
                resolved = []
                for n in names:
                    g = resolve_output_grad(n) if n else None
                    resolved.append(g or "")
                    any_grad = any_grad or bool(g)
                out_grad_slots[slot] = resolved
            if not any_grad:
                continue

            # which inputs get grads?
            in_grad_slots = {}
            role_vars = []
            wants_any = False
            for slot, names in op.inputs.items():
                if opdef is not None and slot in opdef.nondiff_inputs:
                    continue
                grads = []
                for n in names:
                    var = block._find_var_recursive(n) if n else None
                    if (var is None or var.stop_gradient or n in no_grad
                            or not is_floating(var.dtype)):
                        grads.append("")
                        continue
                    gname = new_input_grad_name(n)
                    grads.append(gname)
                    wants_any = True
                    if isinstance(var, Parameter):
                        role_vars.extend([n, gname])
                if any(grads):
                    in_grad_slots[slot + "@GRAD"] = grads
            if not wants_any:
                continue

            grad_inputs = {k: list(v) for k, v in op.inputs.items()}
            for slot, resolved in out_grad_slots.items():
                grad_inputs[slot] = list(op.outputs[slot])
                if any(resolved):
                    grad_inputs[slot + "@GRAD"] = resolved
            attrs = dict(op.attrs)
            attrs["__fwd_inputs__"] = {k: list(v) for k, v in op.inputs.items()}
            attrs["__fwd_outputs__"] = {k: list(v)
                                        for k, v in op.outputs.items()}
            attrs[OP_ROLE_KEY] = OpRole.Backward
            if role_vars:
                attrs[OP_ROLE_VAR_KEY] = role_vars
            block.append_op(op.type + "_grad", inputs=grad_inputs,
                            outputs=in_grad_slots, attrs=attrs)

        # finalize fan-in sums for every var that accumulated contributions,
        # so fluid.gradients() and transpilers see the summed gradient
        for var_name in list(grad_contribs):
            resolve_output_grad(var_name)
        program._grad_name_map = dict(getattr(program, "_grad_name_map", {}))
        program._grad_name_map.update(grad_of)

        # collect (parameter, grad) pairs
        params_and_grads = []
        if parameter_list is not None:
            params = [block._find_var_recursive(p) if isinstance(p, str) else p
                      for p in parameter_list]
        else:
            params = program.global_block().all_parameters()
        for param in params:
            if not getattr(param, "trainable", True) or param.name in no_grad:
                continue
            gname = resolve_output_grad(param.name)
            if gname is None:
                continue
            params_and_grads.append((param, block.var(gname)))
    return params_and_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference ``fluid.gradients`` veneer over append_backward."""
    target = targets[0] if isinstance(targets, (list, tuple)) else targets
    p_g = append_backward(target, no_grad_set=no_grad_set)
    block = target.block
    grad_map = getattr(block.program, "_grad_name_map", {})
    outs = []
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    for v in inputs:
        gname = grad_map.get(v.name, grad_var_name(v.name))
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
