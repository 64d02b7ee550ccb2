"""Carry a scope into the port from plain numpy arrays.

The two packages' startup programs draw from different random streams
(torch.Generator here, jax.random there), so the only way both compute
from the same state is to carry it across: read ``{name: ndarray}`` out
of any source and write it here as torch tensors on the target place.

This is the documented way to move **every persistable** of a JAX
(``paddle_tpu``) scope into the port: parameters (conv filters, fc
weights and biases, BN scale and bias), BN running mean and variance,
and for a training program also the optimizer's state (Momentum's
``velocity``; Adam's ``moment1``/``moment2``,
``beta1_pow_acc``/``beta2_pow_acc``) and the global ``learning_rate``.
The port's layers and optimizers name them as the JAX package does, so
the same program built in both packages reads the same names.  A
parameter created inside a control-flow op's step block (``StaticRNN``,
``DynamicRNN``) lives in the global block in both packages, so it is
carried like any other::

    names = [v.name for v in jax_main.list_vars() if v.persistable]
    arrays = {n: np.asarray(jax_scope.find_var(n)) for n in names}
    fluid.load_numpy_params(port_scope, arrays, fluid.CUDAPlace(0))

Under tensor or expert parallelism the JAX package holds every weight at
its global shape (GSPMD shards the storage); pass the transpiled
``program=`` and each rank keeps its shard: the slice on the sharded dim
for mp, the expert slice for ep, and the same slice of the weight's
optimizer state (``model_parallel.shard_state``).
"""

import numpy as np
import torch

from .executor import device_for_place


def load_numpy_params(scope, arrays, place, program=None):
    """Write ``{var name: np.ndarray}`` into ``scope`` as torch tensors on
    ``place``'s device.  Arrays are copied; dtypes are kept (float64
    stays float64 — cast before calling if the program wants float32).
    With ``program`` (transpiled for tensor or expert parallelism, in a
    world of ranks) a sharded weight and its optimizer state keep this
    rank's slice of the global array."""
    from . import model_parallel
    device = device_for_place(place)
    par = model_parallel.context(program) if program is not None else {}
    for name, arr in arrays.items():
        t = torch.from_numpy(np.array(arr, copy=True))
        if par:
            t = model_parallel.shard_state(program, name, t, par)
        scope.set_var(name, t.to(device))
