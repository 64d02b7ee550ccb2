"""LayerHelper (reference: python/paddle/fluid/layer_helper.py).

Bridges layer functions to the IR: creates parameters in the main program's
global block, mirrors them into the startup program with their initializer
op, and appends compute ops to the current block.
"""

import copy

from .framework import default_main_program, default_startup_program
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr
from . import unique_name


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(
            layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        # copy before naming: a user ParamAttr may be reused across layers
        # (the reference deep-copies too) — mutating it would silently alias
        # every layer onto one parameter
        attr = copy.copy(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name,
                                                       "b" if is_bias else "w"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        shape = [int(s) for s in shape]
        param = self.block.create_parameter(
            shape=shape, dtype=dtype, name=attr.name, trainable=attr.trainable,
            regularizer=attr.regularizer, initializer=init)
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        param.gradient_clip_attr = attr.gradient_clip
        # mirror into startup program with its init op; the startup var is
        # a plain Variable, so mark it as parameter-backed structurally
        sb = self.startup_program.global_block()
        if not sb.has_var_local(param.name):
            sb.create_var(name=param.name, shape=param.shape,
                          dtype=param.dtype, persistable=True)
            init(sb.vars[param.name], sb)
        sb.vars[param.name].is_parameter = True
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, **kwargs):
        return self.block.create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        gb = self.main_program.global_block()
        return gb.create_var(persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, **kwargs):
        gb = self.main_program.global_block()
        if gb.has_var_local(name):
            return gb.vars[name]
        return gb.create_var(name=name, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Also create + init the var in the startup program (optimizer
        accumulators, the learning rate)."""
        sb = self.startup_program.global_block()
        if not sb.has_var_local(var.name):
            sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                          persistable=True)
            initializer(sb.vars[var.name], sb)
        return var

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    def append_activation(self, out_var, act=None):
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return out_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=out_var.dtype)
        tmp.shape = out_var.shape
        self.append_op(act_type, inputs={"X": [out_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
