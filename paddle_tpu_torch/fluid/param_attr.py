"""ParamAttr (reference: python/paddle/fluid/param_attr.py)."""

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        raise TypeError("Unsupported param_attr: %r" % (arg,))


class WeightNormParamAttr(ParamAttr):
    """A ParamAttr that carries ``dim`` (JAX param_attr.py:35).  As in the
    JAX package, nothing reparametrises the weight: a layer given one
    creates and trains a plain parameter."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
