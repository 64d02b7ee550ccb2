"""Int8 block-scaled quantized collectives with error feedback
(counterpart ``paddle_tpu/fluid/quantized_collectives.py``; EQuARX,
PAPERS.md).

Gradient payloads travel as int8 with one fp32 max-abs scale per block
of ``block_size`` elements, about a quarter of the fp32 wire, while an
error-feedback residual (the local quantization error, added back into
the next step's gradient) keeps the loss curve.

The quantized all-reduce is the two-phase exchange, both phases
quantized on the wire:

1. **reduce-scatter phase**: each rank quantizes its whole (compensated)
   gradient and ``all_to_all``s the int8 blocks and the fp32 scales, so
   rank d receives every rank's copy of block shard d, dequantizes and
   sums in fp32, in rank order (a sum of raw int8 would wrap, and an
   NCCL reduce would sum in an order of its own);
2. **all-gather phase**: the reduced fp32 shard is requantized and
   ``all_gather``ed back as int8 and scales.

Each rank is a process of a ``torch.distributed`` group (the port's
``fluid/distributed.py``).  NCCL moves card tensors as they are; a gloo
group moves host tensors, so a card tensor on a gloo group is staged
through host memory (:func:`exchange`).  The route is the group's
backend, never a caught error.

The quantizer is elementwise arithmetic and a max-abs reduction, as in
the JAX package (``jnp`` ops there, no Pallas kernel), so plain torch ops
are its port: a true division ``x / scale``, ``torch.round`` (half to
even, as ``jnp.round``), a clip to +-127, and a scale of 1.0 on an
all-zero block; the blocks and scales are the JAX package's bit for bit.
Every product and sum after it is one fp32 operation rounded on its own,
as the JAX source writes them.  XLA may contract a product and the sum
after it into one fused multiply-add, depending on how it fuses the
program around it, so the JAX package's partial sums, residuals and
what follows from them may differ from these by one fp32 rounding.

The all-to-all of activations (the MoE dispatch, Ulysses' head swap) is
:func:`quantized_all_to_all`: fp32 as it is, bf16 cast, or int8 against
one max-abs scale per token (last-dim row) with no error feedback, as a
token crosses the wire once.
"""

import torch

DEFAULT_BLOCK_SIZE = 256

PRECISIONS = ("fp32", "bf16", "int8")


def resolve_precision(precision=None, use_bf16=False):
    """Wire precision from the ``precision`` knob, with the older
    ``use_bf16`` bool as fallback: ONE resolver for the transpiler, the
    fleet strategy and the ops, so an explicit precision always wins."""
    if precision in (None, "", False):
        return "bf16" if use_bf16 else "fp32"
    if precision not in PRECISIONS:
        raise ValueError("allreduce_precision must be one of %s, got %r"
                         % (PRECISIONS, precision))
    return precision


# ---------------------------------------------------------------------------
# Blockwise quantization
# ---------------------------------------------------------------------------

def _block_quantize(x):
    """Quantize ``x [..., bs]`` to int8 against per-row max-abs scales:
    ``scale = max|row| / 127`` (1.0 for an all-zero row), ``q =
    round(x / scale)`` clipped to +-127.  Returns (q int8, scales f32 of
    shape ``x.shape[:-1]``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(-1)), -127.0, 127.0)
    return q.to(torch.int8), scale


def _block_dequantize(q, scale):
    """Inverse of :func:`_block_quantize` (fp32 result)."""
    return q.float() * scale.unsqueeze(-1)


def quantize_block_scaled(x, block_size=DEFAULT_BLOCK_SIZE, pad_to=1):
    """Flatten ``x``, zero-pad to a whole number of blocks (the block
    count also padded to a multiple of ``pad_to``, the world size, so the
    two-phase exchange splits evenly) and quantize each block.  Returns
    ``(q int8 [B, bs], scales f32 [B], numel)``."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    bs = int(block_size)
    blocks = block_count(n, bs, pad_to)
    if blocks * bs > n:
        flat = torch.cat([flat, flat.new_zeros(blocks * bs - n)])
    q, scales = _block_quantize(flat.reshape(blocks, bs))
    return q, scales, n


def dequantize_block_scaled(q, scales, numel, shape, dtype):
    """Inverse of :func:`quantize_block_scaled`: dequantize, drop the
    padding, restore ``shape`` and ``dtype``."""
    flat = _block_dequantize(q, scales).reshape(-1)[:numel]
    return flat.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# The exchanges over a process group
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def staged(group, t):
    """True when ``t`` must go through host memory for ``group``: a card
    tensor on a gloo group (gloo moves card tensors for broadcast and
    all_reduce only).  Under NCCL nothing is staged."""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def exchange(kind, out, inp, group):
    """One tiled collective into ``out``: ``"all_to_all"`` (equal splits
    along dim 0), ``"all_gather"`` (ranks' ``inp`` stacked along dim 0)
    or ``"reduce_scatter"`` (sum, rank r keeps the r-th of N parts),
    staged through host memory when :func:`staged` says so."""
    dist = _dist()
    fn = {"all_to_all": dist.all_to_all_single,
          "all_gather": getattr(dist, "all_gather_single", None) or
          dist.all_gather_into_tensor,
          "reduce_scatter": getattr(dist, "reduce_scatter_single", None) or
          dist.reduce_scatter_tensor}[kind]
    if staged(group, inp):
        host = torch.empty(out.shape, dtype=out.dtype)
        fn(host, inp.cpu(), group=group)
        out.copy_(host)
    else:
        fn(out, inp.contiguous(), group=group)
    return out


def _world_size(group):
    return _dist().get_world_size(group)


def _residual(xf, residual):
    if residual is None:
        return xf
    return xf + residual.float().reshape(xf.shape)


def _phase1(q, scales, group, n_ranks, block_size):
    """all_to_all the int8 blocks and scales; this rank's block shard,
    dequantized and summed over the ranks in rank order in fp32."""
    routed_q = exchange("all_to_all", torch.empty_like(q), q, group)
    routed_s = exchange("all_to_all", torch.empty_like(scales), scales,
                        group)
    shard = q.shape[0] // n_ranks
    part = routed_q.reshape(n_ranks, shard, block_size)
    scale = routed_s.reshape(n_ranks, shard).unsqueeze(-1)
    part = part.float() * scale
    reduced = part[0]
    for r in range(1, n_ranks):
        reduced = reduced + part[r]
    return reduced


def _error(xf, q, scales):
    """The local quantization error ``xf - dequant(q, scales)`` of the
    flat ``xf`` (its first ``xf.numel()`` dequantized elements)."""
    return xf - _block_dequantize(q, scales).reshape(-1)[:xf.numel()]


def _gather(q, scales, group, n_ranks):
    gq = exchange("all_gather", q.new_empty((n_ranks * q.shape[0],) +
                                            tuple(q.shape[1:])), q, group)
    gs = exchange("all_gather", scales.new_empty(n_ranks * scales.shape[0]),
                  scales, group)
    return _block_dequantize(gq, gs).reshape(-1)


def quantized_psum(x, group, block_size=DEFAULT_BLOCK_SIZE, residual=None):
    """Sum ``x`` over ``group``'s ranks with int8 block-scaled payloads
    (quantize → all_to_all → fp32 partial sums → requantize →
    all_gather).

    ``residual`` (``x``'s shape, fp32) engages error feedback: it is
    added to ``x`` before quantizing, and the new local quantization
    error comes back as the second element (None without a residual).
    In a world of one the value still goes through the quantizer, so a
    one-rank run shows the numerics.  Returns ``(summed in x.dtype,
    new_residual)``."""
    n_ranks = _world_size(group)
    xf = _residual(x.float(), residual)
    q, scales, n = quantize_block_scaled(xf, block_size, pad_to=n_ranks)
    bs = q.shape[1]
    new_res = None
    if residual is not None:
        new_res = _error(xf.reshape(-1), q, scales).reshape(xf.shape)
    if n_ranks == 1:
        out = _block_dequantize(q, scales).reshape(-1)[:n]
        return out.reshape(x.shape).to(x.dtype), new_res
    reduced = _phase1(q, scales, group, n_ranks, bs)
    q2, s2 = _block_quantize(reduced)
    out = _gather(q2, s2, group, n_ranks)[:n]
    return out.reshape(x.shape).to(x.dtype), new_res


def quantized_reduce_scatter(x, group, block_size=DEFAULT_BLOCK_SIZE,
                             residual=None):
    """Phase 1 of :func:`quantized_psum` alone (the gradient half of
    weight-update sharding): quantize the (compensated) 1-D ``x``,
    all_to_all the blocks and scales, sum in fp32.  ``x.numel()`` must
    divide by ``N * block_size`` (the transpiler pads its buckets so).
    Returns ``(this rank's x.numel() // N reduction, new_residual)``."""
    n_ranks = _world_size(group)
    bs = int(block_size)
    xf = x.reshape(-1).float()
    if xf.numel() % (bs * n_ranks):
        raise ValueError(
            "quantized_reduce_scatter needs numel %% (block_size * N) "
            "== 0, got numel=%d block_size=%d N=%d"
            % (xf.numel(), bs, n_ranks))
    xf = _residual(xf, residual)
    q, scales = _block_quantize(xf.reshape(-1, bs))
    new_res = None
    if residual is not None:
        new_res = _error(xf, q, scales)
    if n_ranks == 1:
        return _block_dequantize(q, scales).reshape(-1).to(x.dtype), new_res
    reduced = _phase1(q, scales, group, n_ranks, bs)
    return reduced.reshape(-1).to(x.dtype), new_res


def quantized_all_gather(x, group, block_size=DEFAULT_BLOCK_SIZE,
                         residual=None):
    """Phase 2 of :func:`quantized_psum` alone: quantize this rank's 1-D
    shard (``x.numel()`` divides by ``block_size``), all_gather the
    blocks and scales, dequantize.  Weight-update sharding gathers the
    shard's parameter DELTA this way (update-sized values, the range of
    gradients), its residual sharded like the moments.  Returns
    ``(gathered [N * x.numel()], new_residual)``."""
    n_ranks = _world_size(group)
    bs = int(block_size)
    xf = x.reshape(-1).float()
    if xf.numel() % bs:
        raise ValueError(
            "quantized_all_gather needs numel %% block_size == 0, got "
            "numel=%d block_size=%d" % (xf.numel(), bs))
    xf = _residual(xf, residual)
    q, scales = _block_quantize(xf.reshape(-1, bs))
    new_res = None
    if residual is not None:
        new_res = _error(xf, q, scales)
    return _gather(q, scales, group, n_ranks).to(x.dtype), new_res


# ---------------------------------------------------------------------------
# Wire-byte accounting (the JAX package's convention)
# ---------------------------------------------------------------------------

def block_count(numel, block_size=DEFAULT_BLOCK_SIZE, world_size=1):
    """Blocks a ``numel``-element payload quantizes into, including the
    padding the exchange sends: the count is padded to a multiple of
    ``world_size``."""
    blocks = -(-int(numel) // int(block_size))
    ws = int(world_size)
    return -(-blocks // ws) * ws


def phase_wire_bytes(numel, precision, block_size=DEFAULT_BLOCK_SIZE,
                     itemsize=4, world_size=1):
    """Per-rank wire bytes of ONE phase (a reduce-scatter or an
    all-gather) moving ``numel`` logical elements, the global size.
    int8 counts a byte per element plus the fp32 block scales."""
    numel = int(numel)
    if precision == "bf16":
        return 2 * numel
    if precision == "int8":
        blocks = block_count(numel, block_size, world_size)
        return blocks * int(block_size) + 4 * blocks
    return int(itemsize) * numel


def allreduce_wire_bytes(numel, precision, block_size=DEFAULT_BLOCK_SIZE,
                         itemsize=4, world_size=1):
    """Per-rank wire bytes of ONE all-reduce, counted as its two phases
    (reduce-scatter + all-gather), so fp32 and the int8 exchange compare
    like for like."""
    return 2 * phase_wire_bytes(numel, precision, block_size=block_size,
                                itemsize=itemsize, world_size=world_size)


# ---------------------------------------------------------------------------
# The all-to-all of activations (the MoE dispatch)
# ---------------------------------------------------------------------------

def quantized_all_to_all(x, group, split_axis=0, concat_axis=0,
                         precision="fp32", axis="ep"):
    """Tiled all-to-all over ``group`` (``lax.all_to_all(...,
    tiled=True)``: ``x`` cut into N chunks along ``split_axis``, chunk j
    to rank j, the received chunks concatenated along ``concat_axis`` in
    rank order) with the wire in ``precision``:

    - ``fp32``: the exchange as it is (also any non-float payload);
    - ``bf16``: the payload cast to bf16 and back;
    - ``int8``: each last-dim row quantized against its own max-abs
      scale (the blocks' rule, :func:`_block_quantize`), the int8 rows
      and the fp32 scales exchanged, dequantized on arrival; no error
      feedback.  ``split_axis``/``concat_axis`` must not be the last
      axis, which carries the scale.

    Not differentiable by itself (``paddle_tpu_torch.parallel.
    all_to_all`` is the autograd node).  Counts one call and the
    per-rank wire bytes (:func:`alltoall_wire_bytes`) under ``("a2a",
    axis)`` in ``parallel.tensor_parallel.comm``."""
    from ..parallel.expert_parallel import _exchange
    from ..parallel.tensor_parallel import count
    if precision not in PRECISIONS:
        raise ValueError("unknown a2a precision %r" % (precision,))
    eff = precision if x.is_floating_point() else "fp32"
    count("a2a", axis, alltoall_wire_bytes(x.shape, eff,
                                           itemsize=x.element_size()))
    if eff == "fp32":
        return _exchange(x, group, split_axis, concat_axis)
    if eff == "bf16":
        return _exchange(x.to(torch.bfloat16), group, split_axis,
                         concat_axis).to(x.dtype)
    if split_axis >= x.dim() - 1 or concat_axis >= x.dim() - 1:
        raise ValueError(
            "int8 all_to_all splits/concats leading axes only (the last "
            "axis carries the per-token scale); got split_axis=%d, "
            "concat_axis=%d for ndim=%d" % (split_axis, concat_axis,
                                            x.dim()))
    q, scale = _block_quantize(x)
    q2 = _exchange(q, group, split_axis, concat_axis)
    s2 = _exchange(scale, group, split_axis, concat_axis)
    return _block_dequantize(q2, s2).to(x.dtype)


def alltoall_wire_bytes(shape, precision, itemsize=4):
    """Per-rank wire bytes of ONE tiled all-to-all of ``shape``: the
    tensor crosses the wire once; int8 adds the fp32 per-token scales
    (one per last-dim row)."""
    shape = tuple(int(d) for d in shape)
    numel = 1
    for d in shape:
        numel *= d
    if precision == "bf16":
        return 2 * numel
    if precision == "int8":
        tokens = numel // shape[-1] if len(shape) > 1 else 1
        return numel + 4 * tokens
    return int(itemsize) * numel
