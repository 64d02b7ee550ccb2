"""Optimizer op lowerings (counterpart ``paddle_tpu/fluid/ops/
optimizer_ops.py``): ``adam`` only.

Each op reads Param/Grad/state and writes its ``*Out`` slots under the
same names; the executor writes them back to the scope.  The update is
functional, not in place: a new tensor per output, so no tensor that an
autograd graph saved is ever mutated.  That costs one allocation per
output; an in-place (or fused multi-tensor) update is a choice left for
later, made together with capturing the step in a CUDA graph.
"""

import numpy as np
import torch

from ..registry import register_op


@register_op("adam", stop_gradient=True)
def _adam(ctx, op):
    """optimizer_ops.py:60, the same arithmetic in the same order:
    ``m1 = b1·m1 + (1−b1)·g``, ``m2 = b2·m2 + (1−b2)·g²``,
    ``lr_t = lr·sqrt(1−β2^t)/(1−β1^t)``, ``p − lr_t·m1/(sqrt(m2)+eps)``.
    The constants are rounded to float32 first, as JAX's
    ``jnp.asarray(beta, p.dtype)``; (1 − b) is then taken in float32."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    m1 = ctx.i("Moment1")
    m2 = ctx.i("Moment2")
    b1p = ctx.i("Beta1Pow").reshape(()).to(p.dtype)
    b2p = ctx.i("Beta2Pow").reshape(()).to(p.dtype)
    lr = ctx.i("LearningRate").reshape(()).to(p.dtype)
    b1 = np.float32(ctx.attr("beta1", 0.9))
    b2 = np.float32(ctx.attr("beta2", 0.999))
    eps = float(np.float32(ctx.attr("epsilon", 1e-8)))
    m1n = float(b1) * m1 + float(np.float32(1) - b1) * g
    m2n = float(b2) * m2 + float(np.float32(1) - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    ctx.set("ParamOut", p - lr_t * m1n / (torch.sqrt(m2n) + eps))
    ctx.set("Moment1Out", m1n)
    ctx.set("Moment2Out", m2n)
