"""NN op lowerings of the slice: layer_norm, dropout and
softmax_with_cross_entropy (counterpart ``paddle_tpu/fluid/ops/
nn_ops.py``), in plain torch."""

import torch

from ..registry import register_op


@register_op("layer_norm")
def _layer_norm(ctx, op):
    """Statistics in float32 whatever the input dtype; outputs Y and the
    per-row Mean / Variance (population variance), as nn_ops.py:285."""
    x = ctx.i("X")
    scale = ctx.i_opt("Scale")
    bias = ctx.i_opt("Bias")
    eps = ctx.attr("epsilon", 1e-5)
    bna = ctx.attr("begin_norm_axis", 1)
    dims = tuple(range(bna, x.dim()))
    xm = x.float()
    var, mean = torch.var_mean(xm, dim=dims, keepdim=True, correction=0)
    y = (xm - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.float().reshape(norm_shape)
    if bias is not None:
        y = y + bias.float().reshape(norm_shape)
    lead = tuple(x.shape[:bna])
    ctx.set("Y", y.to(x.dtype))
    ctx.set("Mean", mean.reshape(lead))
    ctx.set("Variance", var.reshape(lead))


def keep_mask(ctx, p, shape):
    """bool keep mask, each element kept with probability ``1 - p``,
    drawn from the op's generator (Philox on the card).  The JAX package
    draws ``jax.random.bernoulli``: the same law, other bits."""
    u = torch.rand(shape, generator=ctx.generator(),
                   device=ctx.state.device)
    return u < 1.0 - p


@register_op("dropout")
def _dropout(ctx, op):
    """nn_ops.py:308.  Train mode keeps each element with probability
    1 - p; ``upscale_in_train`` divides the kept ones by 1 - p,
    ``downgrade_in_infer`` leaves them and scales at inference instead.
    Mask is the uint8 keep mask; dropout_grad differentiates the taped
    forward, so it uses this very mask."""
    x = ctx.i("X")
    p = ctx.attr("dropout_prob", 0.5)
    upscale = ctx.attr("dropout_implementation",
                       "downgrade_in_infer") == "upscale_in_train"
    if ctx.attr("is_test", False) or ctx.state.is_test:
        ctx.set("Out", x if upscale else x * (1.0 - p))
        ctx.set("Mask", torch.ones_like(x, dtype=torch.uint8))
        return
    keep = keep_mask(ctx, p, x.shape)
    if upscale:
        out = torch.where(keep, x / max(1.0 - p, 1e-8), torch.zeros_like(x))
    else:
        out = torch.where(keep, x, torch.zeros_like(x))
    ctx.set("Out", out)
    ctx.set("Mask", keep.to(torch.uint8))


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def _softmax_with_cross_entropy(ctx, op):
    """nn_ops.py:336: log-softmax in float32, hard or soft labels,
    ``ignore_index`` rows give 0 loss.  Loss ``[..., 1]``."""
    logits = ctx.i("Logits")
    label = ctx.i("Label")
    log_sm = torch.log_softmax(logits.float(), dim=-1)
    ctx.set("Softmax", torch.exp(log_sm).to(logits.dtype))
    if ctx.attr("soft_label", False):
        loss = -(label.float() * log_sm).sum(-1, keepdim=True)
    else:
        lab = label
        if lab.dim() == logits.dim() and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        lab = lab.long()
        loss = -torch.gather(log_sm, -1, lab.clamp_min(0).unsqueeze(-1))
        ignore_index = ctx.attr("ignore_index", -100)
        if ignore_index >= 0:
            loss = loss.masked_fill((lab == ignore_index).unsqueeze(-1),
                                    0.0)
    ctx.set("Loss", loss.to(logits.dtype))
