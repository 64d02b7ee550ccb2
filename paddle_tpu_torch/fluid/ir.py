"""Program-level IR passes (reference: ``paddle/fluid/framework/ir/`` —
``ir::Pass`` + PassRegistry, fusion passes like ``conv_bn_fuse_pass.cc``;
counterpart ``paddle_tpu/fluid/ir.py``).

The semantic rewrites of an inference program: folding trained BatchNorm
statistics into conv weights and stripping train-only ops, plus the
registry/apply plumbing; and ``sync_batch_norm_pass`` for data
parallel.  Passes operate on (Program, Scope): unlike the
reference's ir::Graph they rewrite parameter *values* too (conv-bn
folding changes weights), on the device the scope holds them on.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP item:
``int8_execute_pass`` (item 13, the quant ops).
"""

import torch

from .data_types import canonical_dtype

PASS_REGISTRY = {}


def register_pass(name):
    def deco(cls_or_fn):
        PASS_REGISTRY[name] = cls_or_fn
        return cls_or_fn
    return deco


def get_pass(name):
    if name not in PASS_REGISTRY:
        raise KeyError("no pass registered under %r" % name)
    return PASS_REGISTRY[name]


def apply_passes(program, scope, pass_names):
    for name in pass_names:
        get_pass(name)(program, scope)
    return program


def _producers(block):
    """var name -> index of the op producing it (last write wins)."""
    prod = {}
    for i, op in enumerate(block.ops):
        for n in op.output_arg_names():
            prod[n] = i
    return prod


def _consumers(block):
    cons = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names():
            cons.setdefault(n, []).append(i)
    return cons


@register_pass("delete_dropout_pass")
def delete_dropout_pass(program, scope=None):
    """Inference: dropout(is_test) is a deterministic scale (or identity)
    — replace the op so the program draws no random numbers at all."""
    for block in program.blocks:
        new_ops = []
        for op in block.ops:
            if op.type != "dropout":
                new_ops.append(op)
                continue
            x = op.input("X")[0]
            out = op.output("Out")[0]
            impl = op.attr("dropout_implementation", "downgrade_in_infer")
            p = op.attr("dropout_prob", 0.5)
            if impl == "upscale_in_train":
                op2 = type(op)(block, "assign", attrs={})
            else:
                op2 = type(op)(block, "scale",
                               attrs={"scale": float(1.0 - p), "bias": 0.0})
            op2.inputs = {"X": [x]}
            op2.outputs = {"Out": [out]}
            new_ops.append(op2)
        block.ops = new_ops
    program._bump_version()
    return program


@register_pass("conv_bn_fuse_pass")
def conv_bn_fuse_pass(program, scope):
    """Fold inference BatchNorm into the preceding conv's weights
    (reference ``ir/conv_bn_fuse_pass.cc``): the BN normalize pass over
    the conv output disappears.

    Pattern: conv2d → [elementwise_add(bias)] → batch_norm(is_test).
    W' = W·γ/σ (per out-channel), b' = (b−μ)·γ/σ + β, with the JAX
    package's float32 order of operations.
    """
    block = program.global_block()
    producers = _producers(block)
    consumers = _consumers(block)
    removed = set()

    for bn_idx, bn in enumerate(block.ops):
        if bn.type != "batch_norm" or not bn.attr("is_test", False):
            continue
        x_name = bn.input("X")[0]
        # single-consumer chain only
        if len(consumers.get(x_name, [])) != 1:
            continue
        prev_idx = producers.get(x_name)
        if prev_idx is None:
            continue
        prev = block.ops[prev_idx]
        bias_op = None
        if prev.type == "elementwise_add":
            bias_op = prev
            conv_out = prev.input("X")[0]
            if len(consumers.get(conv_out, [])) != 1:
                continue
            conv_idx = producers.get(conv_out)
            conv = block.ops[conv_idx] if conv_idx is not None else None
        else:
            conv = prev
        if conv is None or conv.type != "conv2d":
            continue

        w_name = conv.input("Filter")[0]
        scale = scope.find_var(bn.input("Scale")[0])
        bias = scope.find_var(bn.input("Bias")[0])
        mean = scope.find_var(bn.input("Mean")[0])
        var = scope.find_var(bn.input("Variance")[0])
        w = scope.find_var(w_name)
        if any(v is None for v in (scale, bias, mean, var, w)):
            continue
        eps = bn.attr("epsilon", 1e-5)
        factor = (scale / torch.sqrt(var + eps)).to(w.dtype)   # [C_out]
        scope.set_var(w_name, w * factor[:, None, None, None])

        if bias_op is not None:
            b_name = bias_op.input("Y")[0]
            b = scope.find_var(b_name)
            new_b = (b - mean) * factor + bias
            scope.set_var(b_name, new_b.to(b.dtype))
            # bn output now comes straight from the add
            bias_op.outputs["Out"] = [bn.output("Y")[0]]
        else:
            # introduce a bias add holding the folded BN offset
            b_name = w_name + "@bn_folded_bias"
            block.create_var(name=b_name, shape=(factor.shape[0],),
                             dtype=canonical_dtype(w.dtype),
                             persistable=True)
            scope.set_var(b_name, ((0.0 - mean) * factor + bias)
                          .to(w.dtype))
            add = type(bn)(block, "elementwise_add", attrs={"axis": 1})
            add.inputs = {"X": [conv.output("Output")[0]], "Y": [b_name]}
            add.outputs = {"Out": [bn.output("Y")[0]]}
            block.ops[bn_idx] = add
            removed.discard(bn_idx)
            continue
        removed.add(bn_idx)

    block.ops = [op for i, op in enumerate(block.ops) if i not in removed]
    program._bump_version()
    return program


@register_pass("sync_batch_norm_pass")
def sync_batch_norm_pass(program, scope=None):
    """Every batch_norm becomes sync_batch_norm (reference
    ``ir/sync_batch_norm_pass.cc``), so its moments are all-reduced over
    the ranks (ops/nn_ops.py).  The grad ops are renamed too: a grad op
    names its forward by its type's stem."""
    for block in program.blocks:
        for op in block.ops:
            if op.type == "batch_norm":
                op.type = "sync_batch_norm"
            elif op.type == "batch_norm_grad":
                op.type = "sync_batch_norm_grad"
    program._bump_version()
    return program


@register_pass("int8_execute_pass")
def int8_execute_pass(program, scope):
    raise NotImplementedError(
        "int8_execute_pass needs the quant ops (quantized_matmul, "
        "quantized_conv2d), which the port has not yet (ROADMAP queue 1 "
        "item 13)")


# the default inference pipeline (≈ reference
# inference/api/paddle_pass_builder.cc kept-pass list)
DEFAULT_INFERENCE_PASSES = ["delete_dropout_pass", "conv_bn_fuse_pass"]
