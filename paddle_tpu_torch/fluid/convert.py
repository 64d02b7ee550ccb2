"""Carry a scope into the port from plain numpy arrays.

The two packages' startup programs draw from different random streams
(torch.Generator here, jax.random there), so the only way both compute
from the same state is to carry it across: read ``{name: ndarray}`` out
of any source and write it here as torch tensors on the target place.

This is the documented way to move **every persistable** of a JAX
(``paddle_tpu``) scope into the port: parameters, and for a training
program also the optimizer's state (Adam's ``moment1``/``moment2``,
``beta1_pow_acc``/``beta2_pow_acc``) and the global ``learning_rate``.
The port's ``AdamOptimizer`` names them as the JAX package does, so the
same program built in both packages reads the same names::

    names = [v.name for v in jax_main.list_vars() if v.persistable]
    arrays = {n: np.asarray(jax_scope.find_var(n)) for n in names}
    fluid.load_numpy_params(port_scope, arrays, fluid.CUDAPlace(0))
"""

import numpy as np
import torch

from .executor import device_for_place


def load_numpy_params(scope, arrays, place):
    """Write ``{var name: np.ndarray}`` into ``scope`` as torch tensors on
    ``place``'s device.  Arrays are copied; dtypes are kept (float64
    stays float64 — cast before calling if the program wants float32)."""
    device = device_for_place(place)
    for name, arr in arrays.items():
        t = torch.from_numpy(np.array(arr, copy=True))
        scope.set_var(name, t.to(device))
