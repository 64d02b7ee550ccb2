"""Optimizer op lowerings (counterpart ``paddle_tpu/fluid/ops/
optimizer_ops.py``): ``sgd``, ``momentum``, ``lars_momentum``, ``adam``,
``adamax``, ``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``,
``ftrl``, ``lamb``, ``dgc_momentum``, ``proximal_gd``,
``proximal_adagrad`` and ``average_accumulates`` (no optimizer class of
either package appends the last three; programs built by hand do).

Each rule is the JAX rule's arithmetic in the same order.  The JAX rules
round every attribute to the parameter's dtype first
(``jnp.asarray(beta, p.dtype)``) and take ``1 − b`` in that dtype;
:func:`_f32` does the same here, and a Python float that holds a
float32 value multiplies a float32 tensor exactly as that float32 does.
A Python number is never divided by a tensor (torch computes
``c / t`` as ``reciprocal(t) · c``).

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


def _f32(ctx, name, default):
    """The attribute rounded to float32, as a Python float."""
    return float(np.float32(ctx.attr(name, default)))


def _one_minus(b):
    """``1 − b`` in float32 (``b`` already rounded), as a Python float."""
    return float(np.float32(1) - np.float32(b))


def _lr(ctx, p):
    return ctx.i("LearningRate").reshape(()).to(p.dtype)


def _norm(t):
    return torch.sqrt(torch.sum(torch.square(t)))


@register_op("sgd", stop_gradient=True)
def _sgd(ctx, op):
    """optimizer_ops.py:16: ``p − lr·g``."""
    p = ctx.i("Param")
    lr = ctx.i("LearningRate").reshape(()).to(p.dtype)
    ctx.set("ParamOut", p - lr * ctx.i("Grad").to(p.dtype))


@register_op("momentum", stop_gradient=True)
def _momentum(ctx, op):
    """optimizer_ops.py:24, the same arithmetic in the same order:
    ``v = mu·v + g``; ``p − lr·v``, or with Nesterov
    ``p − (g + mu·v)·lr``.  ``mu`` is rounded to the parameter's dtype
    first, as JAX's ``jnp.asarray(mu, p.dtype)``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = ctx.i("LearningRate").reshape(()).to(p.dtype)
    # a 0-d host tensor acts as a scalar on any device (no copy)
    mu = torch.tensor(ctx.attr("mu"), dtype=p.dtype)
    v_new = mu * ctx.i("Velocity") + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set("ParamOut", p_new)
    ctx.set("VelocityOut", v_new)


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


@register_op("lars_momentum", stop_gradient=True)
def _lars_momentum(ctx, op):
    """optimizer_ops.py:40: the local rate ``lr·coeff·‖p‖ / (‖g‖ + wd·‖p‖
    + 1e-12)`` where both norms are positive (else lr),
    ``v = mu·v + local_lr·(g + wd·p)``, ``p − v``.  ``lars_coeff`` and
    ``lars_weight_decay`` enter as weakly typed Python floats there,
    which rounds them to float32 too."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = _lr(ctx, p)
    mu = _f32(ctx, "mu", 0.9)
    coeff = _f32(ctx, "lars_coeff", 0.001)
    wd = _f32(ctx, "lars_weight_decay", 0.0005)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + wd * p_norm + 1e-12), lr)
    v_new = mu * ctx.i("Velocity") + local_lr * (g + wd * p)
    ctx.set("ParamOut", p - v_new)
    ctx.set("VelocityOut", v_new)


@register_op("adamax", stop_gradient=True)
def _adamax(ctx, op):
    """optimizer_ops.py:80: ``m = b1·m + (1−b1)·g``,
    ``u = max(b2·u, |g| + eps)``, ``p − lr/(1−β1^t)·m/u``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    b1p = ctx.i("Beta1Pow").reshape(()).to(p.dtype)
    lr = _lr(ctx, p)
    b1 = _f32(ctx, "beta1", 0.9)
    b2 = _f32(ctx, "beta2", 0.999)
    eps = _f32(ctx, "epsilon", 1e-8)
    m_new = b1 * ctx.i("Moment") + _one_minus(b1) * g
    inf_new = torch.maximum(b2 * ctx.i("InfNorm"), torch.abs(g) + eps)
    lr_t = lr / (1 - b1p)
    ctx.set("ParamOut", p - lr_t * m_new / inf_new)
    ctx.set("MomentOut", m_new)
    ctx.set("InfNormOut", inf_new)


@register_op("adagrad", stop_gradient=True)
def _adagrad(ctx, op):
    """optimizer_ops.py:99: ``M = M + g²``, ``p − lr·g/(sqrt(M) + eps)``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = _lr(ctx, p)
    eps = _f32(ctx, "epsilon", 1e-6)
    mom_new = ctx.i("Moment") + torch.square(g)
    ctx.set("ParamOut", p - lr * g / (torch.sqrt(mom_new) + eps))
    ctx.set("MomentOut", mom_new)


@register_op("decayed_adagrad", stop_gradient=True)
def _decayed_adagrad(ctx, op):
    """optimizer_ops.py:111: ``M = d·M + (1−d)·g²``,
    ``p − lr·g/(sqrt(M) + eps)``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = _lr(ctx, p)
    decay = _f32(ctx, "decay", 0.95)
    eps = _f32(ctx, "epsilon", 1e-6)
    mom_new = decay * ctx.i("Moment") + _one_minus(decay) * torch.square(g)
    ctx.set("ParamOut", p - lr * g / (torch.sqrt(mom_new) + eps))
    ctx.set("MomentOut", mom_new)


@register_op("adadelta", stop_gradient=True)
def _adadelta(ctx, op):
    """optimizer_ops.py:124: ``E[g²] = rho·E[g²] + (1−rho)·g²``,
    ``Δ = −sqrt((E[Δ²] + eps)/(E[g²] + eps))·g``,
    ``E[Δ²] = rho·E[Δ²] + (1−rho)·Δ²``, ``p + Δ`` (no learning rate)."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    asu = ctx.i("AvgSquaredUpdate")
    rho = _f32(ctx, "rho", 0.95)
    eps = _f32(ctx, "epsilon", 1e-6)
    asg_new = rho * ctx.i("AvgSquaredGrad") + _one_minus(rho) * \
        torch.square(g)
    update = -torch.sqrt((asu + eps) / (asg_new + eps)) * g
    asu_new = rho * asu + _one_minus(rho) * torch.square(update)
    ctx.set("ParamOut", p + update)
    ctx.set("AvgSquaredGradOut", asg_new)
    ctx.set("AvgSquaredUpdateOut", asu_new)


@register_op("rmsprop", stop_gradient=True)
def _rmsprop(ctx, op):
    """optimizer_ops.py:140: ``E[g²] = rho·E[g²] + (1−rho)·g²``; centered,
    also ``E[g] = rho·E[g] + (1−rho)·g`` and the denominator
    ``E[g²] − E[g]² + eps``, else ``E[g²] + eps``;
    ``v = momentum·v + lr·g·rsqrt(denominator)``, ``p − v``.  MeanGrad is
    written only when centered."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = _lr(ctx, p)
    rho = _f32(ctx, "decay", 0.95)
    eps = _f32(ctx, "epsilon", 1e-6)
    momentum = _f32(ctx, "momentum", 0.0)
    ms_new = rho * ctx.i("MeanSquare") + _one_minus(rho) * torch.square(g)
    if ctx.attr("centered", False):
        mg_new = rho * ctx.i("MeanGrad") + _one_minus(rho) * g
        denom = ms_new - torch.square(mg_new) + eps
        ctx.set("MeanGradOut", mg_new)
    else:
        denom = ms_new + eps
    mom_new = momentum * ctx.i("Moment") + lr * g * torch.rsqrt(denom)
    ctx.set("ParamOut", p - mom_new)
    ctx.set("MeanSquareOut", ms_new)
    ctx.set("MomentOut", mom_new)


@register_op("ftrl", stop_gradient=True)
def _ftrl(ctx, op):
    """optimizer_ops.py:165: ``n' = n + g²``,
    ``z' = z + g − (n'^−k − n^−k)/lr·p`` (k = lr_power),
    ``p = (l1·sign(z') − z') / (n'^−k/lr + 2·l2)`` where ``|z'| > l1``,
    else 0.  The accumulator starts at 0, so the first step reads
    ``0^0.5`` = 0 at the default k = −0.5."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    sq = ctx.i("SquaredAccumulator")
    lr = _lr(ctx, p)
    l1 = torch.tensor(_f32(ctx, "l1", 0.0), dtype=p.dtype)
    l2 = torch.tensor(_f32(ctx, "l2", 0.0), dtype=p.dtype)
    k = -_f32(ctx, "lr_power", -0.5)
    new_accum = sq + torch.square(g)
    lin_new = (ctx.i("LinearAccumulator") + g -
               (torch.pow(new_accum, k) - torch.pow(sq, k)) / lr * p)
    x = l1 * torch.sign(lin_new) - lin_new
    y = torch.pow(new_accum, k) / lr + 2 * l2
    ctx.set("ParamOut", torch.where(torch.abs(lin_new) > l1, x / y,
                                    torch.zeros_like(p)))
    ctx.set("SquaredAccumOut", new_accum)
    ctx.set("LinearAccumOut", lin_new)


@register_op("lamb", stop_gradient=True)
def _lamb(ctx, op):
    """optimizer_ops.py:187: Adam's moments, ``r = m̂/(sqrt(v̂) + eps) +
    wd·p``, the trust ratio ``‖p‖ / max(‖r‖, 1e-12)`` where both norms
    are positive (else 1), ``p − lr·ratio·r``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    b1p = ctx.i("Beta1Pow").reshape(()).to(p.dtype)
    b2p = ctx.i("Beta2Pow").reshape(()).to(p.dtype)
    lr = _lr(ctx, p)
    b1 = _f32(ctx, "beta1", 0.9)
    b2 = _f32(ctx, "beta2", 0.999)
    eps = _f32(ctx, "epsilon", 1e-6)
    wd = _f32(ctx, "weight_decay", 0.01)
    m1n = b1 * ctx.i("Moment1") + _one_minus(b1) * g
    m2n = b2 * ctx.i("Moment2") + _one_minus(b2) * torch.square(g)
    m1_hat = m1n / (1 - b1p)
    m2_hat = m2n / (1 - b2p)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    ratio = torch.where(
        (p_norm > 0) & (r_norm > 0),
        p_norm / torch.maximum(r_norm, torch.tensor(1e-12, dtype=p.dtype)),
        1.0)
    ctx.set("ParamOut", p - lr * ratio * r)
    ctx.set("Moment1Out", m1n)
    ctx.set("Moment2Out", m2n)


@register_op("dgc_momentum", stop_gradient=True)
def _dgc_momentum(ctx, op):
    """optimizer_ops.py:213, Deep Gradient Compression momentum in its
    convergence mode: ``u = m·u + g``, ``v = v + u``; the entries of
    ``|v|`` at or above the threshold ``sort(|v|)[k]`` (k the sparsity
    of the rampup schedule times numel, in float32) are sent, summed
    over the ranks and averaged (``__dp_mean__``), and cleared from u and
    v; ``p − lr·sent``.  Before ``rampup_begin_step`` it is momentum on
    the rank-averaged gradient, with u zeroed.  The step is the host's
    (``ExecState.step``), so only the branch taken runs, with its one
    all-reduce in a world of more than one rank; the JAX rule computes
    both and selects.  ``kthvalue`` (k + 1) is the sorted entry at k,
    ties included, as ``>=`` needs."""
    from . import collective_ops
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    u = ctx.i("U")
    v = ctx.i("V")
    lr = _lr(ctx, p)
    m = torch.tensor(ctx.attr("momentum", 0.9), dtype=p.dtype)
    begin = int(ctx.attr("rampup_begin_step", 0))
    rampup = max(int(ctx.attr("rampup_step", 1)), 1)
    sched = list(ctx.attr("sparsity", [0.75, 0.9375, 0.984375, 0.996,
                                       0.999]))
    step = int(ctx.state.step)
    w = collective_ops._world(ctx)

    def world_sum(t):
        d, group, n = w
        y = collective_ops._payload(t, "fp32")
        d.all_reduce(y, group=group)
        collective_ops._count(ctx, "allreduce", "fp32",
                              2 * y.element_size() * y.numel())
        return y, torch.tensor(n, dtype=p.dtype)

    if step < begin:
        g_sync = g
        if w is not None:
            g_sync, n = world_sum(g)
            g_sync = g_sync / n
        v_mom = m * v + g_sync
        ctx.set("ParamOut", p - lr * v_mom)
        ctx.set("UOut", torch.zeros_like(u))
        ctx.set("VOut", v_mom)
        return
    idx = min(max((step - begin) * len(sched) // rampup, 0), len(sched) - 1)
    u_new = m * u + g
    v_new = v + u_new
    flat = torch.abs(v_new).reshape(-1)
    n_el = flat.numel()
    k_idx = min(max(int(np.float32(sched[idx]) * np.float32(n_el)), 0),
                n_el - 1)
    thr = torch.kthvalue(flat, k_idx + 1).values
    mask = (torch.abs(v_new) >= thr).to(p.dtype)
    sync = v_new * mask
    if w is not None:
        sync, n = world_sum(sync)
        if ctx.attr("__dp_mean__", True):
            sync = sync / n
    ctx.set("ParamOut", p - lr * sync)
    ctx.set("UOut", u_new * (1 - mask))
    ctx.set("VOut", v_new * (1 - mask))


def _prox(prox_param, lr, l1, l2):
    """optimizer_ops.py:277, the proximal step of proximal_gd and
    proximal_adagrad (reference optimizers/proximal_gd_op.h:49):
    soft-threshold by ``lr·l1`` when ``l1 > 0``, then shrink by
    ``1/(1 + lr·l2)``."""
    if l1 > 0:
        return (torch.sign(prox_param) *
                torch.clamp_min(torch.abs(prox_param) - lr * l1, 0.0) /
                (1.0 + lr * l2))
    return prox_param / (1.0 + lr * l2)


@register_op("proximal_gd", stop_gradient=True)
def _proximal_gd(ctx, op):
    """optimizer_ops.py:288: ``prox(p − lr·g)``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = _lr(ctx, p)
    ctx.set("ParamOut", _prox(p - lr * g, lr, _f32(ctx, "l1", 0.0),
                              _f32(ctx, "l2", 0.0)))


@register_op("proximal_adagrad", stop_gradient=True)
def _proximal_adagrad(ctx, op):
    """optimizer_ops.py:298: ``m' = m + g²``, ``prox(p − lr·g/sqrt(m'))``."""
    p = ctx.i("Param")
    g = ctx.i("Grad").to(p.dtype)
    lr = _lr(ctx, p)
    m_new = ctx.i("Moment") + g * g
    ctx.set("MomentOut", m_new)
    ctx.set("ParamOut", _prox(p - lr * g / torch.sqrt(m_new), lr,
                              _f32(ctx, "l1", 0.0), _f32(ctx, "l2", 0.0)))


@register_op("average_accumulates", stop_gradient=True)
def _average_accumulates(ctx, op):
    """optimizer_ops.py:311, ModelAverage's accumulator rotation
    (reference average_accumulates_op.h): sum_1 adds the parameter;
    every 16384 updates it drains into sum_2; once the window reaches
    ``min_average_window`` and ``min(max_average_window, num_updates ·
    average_window)`` both drain into sum_3 and the window restarts.
    Counters are int32, as the JAX rule keeps them."""
    kmax = 16384
    param = ctx.i("param")
    s1 = ctx.i("in_sum_1")
    s2 = ctx.i("in_sum_2")
    s3 = ctx.i("in_sum_3")

    def count(slot):
        return ctx.i(slot).reshape(()).to(torch.int32)

    nacc = count("in_num_accumulates")
    old = count("in_old_num_accumulates")
    nupd = count("in_num_updates")
    avg_win = float(np.float32(ctx.attr("average_window", 0.0)))
    max_win = min(ctx.attr("max_average_window", 2 ** 31 - 1), 2 ** 31 - 1)
    min_win = ctx.attr("min_average_window", 10000)

    nupd = nupd + 1
    nacc = nacc + 1
    s1 = s1 + param.to(s1.dtype)
    rotate = torch.remainder(nupd, kmax) == 0
    s2 = torch.where(rotate, s2 + s1, s2)
    s1 = torch.where(rotate, torch.zeros_like(s1), s1)
    window = torch.minimum(torch.tensor(max_win, dtype=torch.int32),
                           (nupd.to(torch.float32) * avg_win).to(torch.int32))
    full = (nacc >= min_win) & (nacc >= window)
    s3 = torch.where(full, s1 + s2, s3)
    s1 = torch.where(full, torch.zeros_like(s1), s1)
    s2 = torch.where(full, torch.zeros_like(s2), s2)
    old = torch.where(full, nacc, old)
    nacc = torch.where(full, torch.zeros_like(nacc), nacc)
    ctx.set("out_sum_1", s1)
    ctx.set("out_sum_2", s2)
    ctx.set("out_sum_3", s3)
    ctx.set("out_num_accumulates", nacc.reshape((1,)))
    ctx.set("out_old_num_accumulates", old.reshape((1,)))
    ctx.set("out_num_updates", nupd.reshape((1,)))
