"""Per-op micro-benchmark harness (counterpart
``paddle_tpu/fluid/benchmark.py``; reference
``paddle/fluid/operators/benchmark/op_tester.{h,cc}``): build a one-op
program, run it repeatedly on the card, report its wall time per
dispatch with the achieved FLOP/s and bytes/s, so a kernel-level
regression shows without a whole model run.

Usage (API)::

    from paddle_tpu_torch.fluid import benchmark
    r = benchmark.bench_op("mul", {"X": [4096, 1024], "Y": [1024, 4096]})
    # {"op": "mul", "ms": ..., "tflops": ..., "gbps": ...,
    #  "flops": <the _FLOPS_EST estimate>, "counted_flops": <the ledger's>}

Usage (CLI, prints a markdown cost table; on the card unless ``--cpu``)::

    python -m paddle_tpu_torch.fluid.benchmark --suite resnet50 --batch 256
    python -m paddle_tpu_torch.fluid.benchmark --suite bert --batch 64
    python -m paddle_tpu_torch.fluid.benchmark --suite moe
    python -m paddle_tpu_torch.fluid.benchmark --op mul --spec \
        '{"X": [512, 512], "Y": [512, 512]}' --cpu

Timing: the feeds lie on the card before the loop, each step is one
``exe.run`` with live-tensor fetches, and ``timing.timed_steps``' fence
(one read of a scalar after the steps, its own cost subtracted) ends the
window; the step count doubles until the window is at least four fence
reads and 20 ms.  A step is one dispatch, so the figure includes the
executor's per-dispatch host work: what a one-op program costs in this
framework, as the reference's op_tester times ``RunImpl`` through the
whole op interface.

The FLOP estimates (``_FLOPS_EST``, the fwd+bwd = 3x fwd rule) are the
JAX package's, so the TFLOP/s column means what it means there.  Beside
each estimate the row carries ``counted_flops``: what the device-cost
ledger (``costmodel.py``) counts for the same step, forward, backward
and the scalar fences included.
"""

import json

import numpy as np

# -- default output slots for ops benched without an explicit spec ---------
_DEFAULT_OUTPUTS = {
    "conv2d": {"Output": 1},
    "depthwise_conv2d": {"Output": 1},
    "mul": {"Out": 1},
    "matmul": {"Out": 1},
    "batch_norm": {"Y": 1, "MeanOut": 1, "VarianceOut": 1,
                   "SavedMean": 1, "SavedVariance": 1},
    "layer_norm": {"Y": 1, "Mean": 1, "Variance": 1},
    "softmax": {"Out": 1},
    "softmax_with_cross_entropy": {"Softmax": 1, "Loss": 1},
    "dropout": {"Out": 1, "Mask": 1},
    "lookup_table": {"Out": 1},
    "fused_attention": {"Out": 1},
    "switch_moe": {"Out": 1, "AuxLoss": 1},
    "pool2d": {"Out": 1},
    "relu": {"Out": 1},
    "gelu": {"Out": 1},
    "tanh": {"Out": 1},
    "elementwise_add": {"Out": 1},
    "elementwise_mul": {"Out": 1},
    "mean": {"Out": 1},
    "sum": {"Out": 1},
    "scale": {"Out": 1},
    "transpose2": {"Out": 1, "XShape": 1},
    "reshape2": {"Out": 1, "XShape": 1},
    "reduce_mean": {"Out": 1},
    "adam": {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
             "Beta1PowOut": 1, "Beta2PowOut": 1},
    "momentum": {"ParamOut": 1, "VelocityOut": 1},
}

# primary (fetched) output slot when several exist
_PRIMARY_OUT = {"batch_norm": "Y", "layer_norm": "Y",
                "softmax_with_cross_entropy": "Loss", "dropout": "Out",
                "transpose2": "Out", "reshape2": "Out",
                "adam": "ParamOut", "momentum": "ParamOut"}


def _conv_flops(inputs, attrs, out_shape):
    n, co, ho, wo = out_shape
    ci = inputs["Filter"].shape[1]           # per-group in channels
    kh, kw = inputs["Filter"].shape[2:4]
    return 2.0 * n * co * ho * wo * ci * kh * kw


def _matmul_flops(inputs, attrs, out_shape):
    x, y = inputs["X"], inputs["Y"]
    k = x.shape[0 if attrs.get("transpose_X") else -1] \
        if x.ndim > 1 else x.shape[-1]
    if attrs.get("transpose_X"):
        k = x.shape[-2] if x.ndim > 1 else x.shape[0]
    else:
        k = x.shape[-1]
    return 2.0 * float(np.prod(out_shape)) * k


_FLOPS_EST = {
    "conv2d": _conv_flops,
    "depthwise_conv2d": _conv_flops,
    "mul": lambda i, a, o: 2.0 * float(np.prod(o)) * i["X"].shape[-1],
    "matmul": _matmul_flops,
    "batch_norm": lambda i, a, o: 5.0 * float(np.prod(i["X"].shape)),
    "layer_norm": lambda i, a, o: 5.0 * float(np.prod(i["X"].shape)),
    "softmax": lambda i, a, o: 4.0 * float(np.prod(o)),
    "pool2d": lambda i, a, o: float(np.prod(o)) *
        (a.get("ksize", [1, 1])[0] * a.get("ksize", [1, 1])[1]
         if not a.get("global_pooling")
         else np.prod(i["X"].shape[2:])),
}


def _timed(step, steps, warmup):
    """``timing.timed_steps``, made adaptive: a small op can cost far
    less than the fence, so the step count doubles until the timed
    window is at least four fence reads and 20 ms.  Returns (seconds,
    steps timed)."""
    from .timing import timed_steps

    for _attempt in range(12):
        detail = {}
        dt, _ = timed_steps(step, steps, warmup=warmup if not _attempt
                            else 1, detail=detail)
        if dt > max(4 * detail["fence_rtt_s"], 0.02):
            return dt, steps
        steps *= 2
    raise RuntimeError(
        "op too cheap to time: window never dominated the fence RTT "
        "(%.2f ms) even at %d steps"
        % (detail["fence_rtt_s"] * 1e3, steps // 2))


def bench_op(op_type, inputs, attrs=None, outputs=None, grad=False,
             steps=50, warmup=5, place=None, flops=None, dtype=None):
    """Benchmark one lowered op on ``place`` (the card by default).

    inputs: slot -> np.ndarray (value) or shape list (zeros, float32 or
    ``dtype``).  Returns a dict with ms (per dispatch), tflops, gbps,
    out_shape, grad, flops (the estimate) and counted_flops (the
    ledger's count of the timed step, None with ``FLAGS_cost_ledger=0``).
    """
    import torch
    import paddle_tpu_torch.fluid as fluid
    from .backward import append_backward
    from . import framework as fw

    attrs = dict(attrs or {})
    arrays = {}
    for slot, v in inputs.items():
        a = v if isinstance(v, np.ndarray) else \
            np.zeros(v, dtype or np.float32)
        arrays[slot] = a
    out_spec = outputs or _DEFAULT_OUTPUTS.get(op_type)
    if out_spec is None:
        raise ValueError("no default output spec for op %r — pass outputs="
                         % op_type)

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.scope_guard(scope), fluid.program_guard(main, startup), \
            fluid.unique_name.guard():
        block = main.global_block()
        in_slots = {}
        for slot, a in arrays.items():
            name = "bench_%s" % slot.lower()
            block.create_var(name=name, shape=a.shape, dtype=str(a.dtype),
                             is_data=True, stop_gradient=False)
            in_slots[slot] = [name]
        out_slots, out_names = {}, {}
        for slot, n in out_spec.items():
            names = ["bench_out_%s_%d" % (slot.lower(), i) for i in range(n)]
            for nm in names:
                block.create_var(name=nm)
            out_slots[slot] = names
            out_names[slot] = names
        block.append_op(op_type, inputs=in_slots, outputs=out_slots,
                        attrs=attrs)
        primary = out_names[_PRIMARY_OUT.get(op_type,
                                             next(iter(out_names)))][0]

        # timed fetches are scalars (the mean of each output), so the
        # fetch moves 4 bytes and the compute is still forced
        def scalar_fence(var_name):
            v = block.var(var_name)
            if v.dtype not in ("float32", "float64"):
                v = fluid.layers.cast(v, "float32")
            return fluid.layers.mean(v)

        if grad:
            loss = scalar_fence(primary)
            append_backward(loss)
            # a float input the op does not differentiate (batch
            # norm's Mean and Variance) has no gradient to fetch
            fetch = [loss.name] + [
                scalar_fence(fw.grad_var_name(names[0])).name
                for slot, names in in_slots.items()
                if arrays[slot].dtype.kind == "f" and
                block.has_var(fw.grad_var_name(names[0]))]
        else:
            fetch = [scalar_fence(primary).name]

        exe = fluid.Executor(place if place is not None
                             else fluid.CUDAPlace(0))
        exe.run(startup)
        dev_feed = {in_slots[s][0]: torch.from_numpy(
            np.ascontiguousarray(a)).to(exe.device)
            for s, a in arrays.items()}

        def step(i):
            return exe.run(main, feed=dev_feed, fetch_list=fetch,
                           return_numpy=False)

        dt, steps = _timed(step, steps, warmup)
        out0 = exe.run(main, feed=dev_feed, fetch_list=[primary],
                       return_numpy=False)[0]
        out_shape = tuple(out0.shape)
        rec = exe.cost_record(main, feed=dev_feed, fetch_list=fetch,
                              stamp=False)

    ms = dt / steps * 1e3
    fl = flops
    if fl is None and op_type in _FLOPS_EST:
        fl = _FLOPS_EST[op_type](arrays, attrs, out_shape)
    if fl is not None and grad:
        fl *= 3.0                              # fwd+bwd ~= 3x fwd
    in_bytes = sum(a.nbytes for a in arrays.values())
    out_bytes = int(np.prod(out_shape)) * arrays[
        next(iter(arrays))].dtype.itemsize if out_shape else 0
    r = {"op": op_type, "ms": round(ms, 4), "out_shape": list(out_shape),
         "grad": bool(grad),
         "counted_flops": None if rec is None else rec["flops"]}
    if fl is not None:
        r["tflops"] = round(fl / (ms * 1e-3) / 1e12, 3)
        r["flops"] = fl
    r["gbps"] = round((in_bytes + out_bytes) / (ms * 1e-3) / 1e9, 2)
    return r


# ---------------------------------------------------------------- suites

def resnet50_suite(batch=256):
    """The distinct (conv/bn/pool/fc) shapes of a ResNet-50 v1.5 step with
    their occurrence counts — mirrors models/resnet.py structure."""
    counts, filters = [3, 4, 6, 3], [64, 128, 256, 512]
    entries = {}

    def add(key, mult, op_type, inputs, attrs, grad=True):
        if key in entries:
            entries[key]["count"] += mult
        else:
            entries[key] = {"op": op_type, "inputs": inputs, "attrs": attrs,
                            "count": mult, "grad": grad, "key": key}

    def conv(cin, cout, k, stride, hw, mult):
        x = [batch, cin, hw, hw]
        w = [cout, cin, k, k]
        add("conv %dx%d %d->%d s%d @%d" % (k, k, cin, cout, stride, hw),
            mult, "conv2d", {"Input": x, "Filter": w},
            {"strides": [stride, stride],
             "paddings": [(k - 1) // 2, (k - 1) // 2]})
        ho = hw // stride
        add("bn %dx%dx%d" % (cout, ho, ho), mult, "batch_norm",
            {"X": [batch, cout, ho, ho], "Scale": [cout], "Bias": [cout],
             "Mean": [cout], "Variance": [cout]}, {})

    conv(3, 64, 7, 2, 224, 1)
    hw, cin = 56, 64
    for st, count in enumerate(counts):
        for i in range(count):
            nf = filters[st]
            stride = 2 if i == 0 and st > 0 else 1
            conv(cin, nf, 1, 1, hw, 1)
            conv(nf, nf, 3, stride, hw, 1)
            conv(nf, nf * 4, 1, 1, hw // stride, 1)
            if cin != nf * 4 or stride != 1:
                conv(cin, nf * 4, 1, stride, hw, 1)
            cin = nf * 4
            hw //= stride
    add("fc 2048->1000", 1, "mul",
        {"X": [batch, 2048], "Y": [2048, 1000]}, {})
    add("global avgpool", 1, "pool2d", {"X": [batch, 2048, 7, 7]},
        {"pooling_type": "avg", "global_pooling": True})
    return list(entries.values())


def bert_suite(batch=64, seq=128, hidden=768, heads=12, vocab=30522):
    """BERT-base step shapes (models/bert.py base_config)."""
    bs = batch * seq
    return [
        {"key": "qkv/attn-out matmul %dx%d" % (hidden, hidden), "op": "mul",
         "inputs": {"X": [bs, hidden], "Y": [hidden, hidden]}, "attrs": {},
         "count": 48, "grad": True},
        {"key": "ffn matmul %d->%d" % (hidden, 4 * hidden), "op": "mul",
         "inputs": {"X": [bs, hidden], "Y": [hidden, 4 * hidden]},
         "attrs": {}, "count": 12, "grad": True},
        {"key": "ffn matmul %d->%d" % (4 * hidden, hidden), "op": "mul",
         "inputs": {"X": [bs, 4 * hidden], "Y": [4 * hidden, hidden]},
         "attrs": {}, "count": 12, "grad": True},
        {"key": "attn scores bmm", "op": "matmul",
         "inputs": {"X": np.zeros((batch, heads, seq, 64), np.float32),
                    "Y": np.zeros((batch, heads, seq, 64), np.float32)},
         "attrs": {"transpose_Y": True}, "count": 24, "grad": True},
        {"key": "attn softmax", "op": "softmax",
         "inputs": {"X": [batch, heads, seq, seq]},
         "attrs": {"axis": -1}, "count": 12, "grad": True},
        {"key": "layer_norm", "op": "layer_norm",
         "inputs": {"X": [bs, hidden], "Scale": [hidden], "Bias": [hidden]},
         "attrs": {"begin_norm_axis": 1}, "count": 25, "grad": True},
        {"key": "gelu", "op": "gelu",
         "inputs": {"X": [bs, 4 * hidden]}, "attrs": {}, "count": 12,
         "grad": True},
        {"key": "dropout", "op": "dropout",
         "inputs": {"X": [bs, 4 * hidden]},
         "attrs": {"dropout_prob": 0.1}, "count": 12, "grad": True},
        {"key": "embedding lookup", "op": "lookup_table",
         "inputs": {"W": np.zeros((vocab, hidden), np.float32),
                    "Ids": np.zeros((bs, 1), np.int64)},
         "attrs": {}, "count": 1, "grad": True},
        {"key": "mlm logits %d->%d" % (hidden, vocab), "op": "mul",
         "inputs": {"X": [batch * 20, hidden], "Y": [hidden, vocab]},
         "attrs": {}, "count": 1, "grad": True},
    ]


def attention_moe_suite(batch=8, seq=512, hidden=768, heads=12,
                        experts=8, ffn=3072):
    """Fused (flash) attention at growing sequence lengths and the
    switch-MoE block: the shapes the SP/EP features route through
    (ops/attention_ops.py, ops/moe_ops.py)."""
    D = hidden // heads
    rows = []
    for S in (seq, 2 * seq, 4 * seq):
        for causal in (False, True):
            rows.append({
                "key": "%sfused_attention S=%d"
                       % ("causal " if causal else "", S),
                "op": "fused_attention",
                "inputs": {"Q": [batch, heads, S, D],
                           "K": [batch, heads, S, D],
                           "V": [batch, heads, S, D]},
                "attrs": {"scale": D ** -0.5, "causal": causal},
                "count": 12, "grad": True})
    # attention-probability dropout: routes through the exact
    # composition (the kernel has no RNG), so this row against the plain
    # S=seq row above is the cost of training-time attention dropout
    rows.append({
        "key": "fused_attention dropout=0.1 S=%d" % seq,
        "op": "fused_attention",
        "inputs": {"Q": [batch, heads, seq, D],
                   "K": [batch, heads, seq, D],
                   "V": [batch, heads, seq, D]},
        "attrs": {"scale": D ** -0.5, "causal": False,
                  "attn_dropout": 0.1},
        "count": 12, "grad": True})
    rows.append({
        "key": "switch_moe E=%d ffn=%d S=%d" % (experts, ffn, seq),
        "op": "switch_moe",
        "inputs": {"X": [batch, seq, hidden],
                   "RouterW": [hidden, experts],
                   "W1": [experts, hidden, ffn],
                   "W2": [experts, ffn, hidden]},
        "attrs": {"capacity_factor": 1.25, "act": "gelu"},
        "count": 12, "grad": True})
    return rows


def run_suite(entries, steps=30, warmup=3, place=None, progress=True):
    """Run a suite; returns rows sorted by total time (count x ms).  Each
    row is printed to stderr as it completes, so a run cut short keeps
    the rows it measured; an entry that fails keeps its row, with the
    error."""
    import sys as _sys

    rows = []
    for e in entries:
        try:
            r = bench_op(e["op"], e["inputs"], e["attrs"],
                         grad=e.get("grad", False), steps=steps,
                         warmup=warmup, place=place)
        except Exception as exc:  # keep the table even if one shape fails
            rows.append({"key": e["key"], "op": e["op"], "error": str(exc),
                         "count": e["count"], "ms": float("nan"),
                         "total_ms": float("nan")})
            if progress:
                print("# %s: error %s" % (e["key"], str(exc)[:80]),
                      flush=True, file=_sys.stderr)
            continue
        r["key"] = e["key"]
        r["count"] = e["count"]
        r["total_ms"] = round(r["ms"] * e["count"], 3)
        rows.append(r)
        if progress:
            print("row %s | count %d | %.3f ms | %.2f tflops" % (
                e["key"], e["count"], r["ms"], r.get("tflops", 0.0)),
                flush=True, file=_sys.stderr)
    rows.sort(key=lambda r: -(r["total_ms"]
                              if r["total_ms"] == r["total_ms"] else -1))
    return rows


def format_table(rows, title):
    out = ["## %s" % title, "",
           "| op shape | count | ms/op (fwd+bwd) | total ms | TFLOP/s | GB/s |",
           "|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            out.append("| %s | %d | error: %s | | | |"
                       % (r["key"], r["count"], r["error"][:60]))
        else:
            out.append("| %s | %d | %.3f | %.1f | %s | %.1f |"
                       % (r["key"], r["count"], r["ms"], r["total_ms"],
                          ("%.2f" % r["tflops"]) if "tflops" in r else "—",
                          r["gbps"]))
    return "\n".join(out)


def main(argv=None):
    import argparse
    import paddle_tpu_torch.fluid as fluid

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--suite", choices=["resnet50", "bert", "moe",
                                       "attention_moe"])
    p.add_argument("--op")
    p.add_argument("--spec", help="JSON slot->shape map for --op")
    p.add_argument("--attrs", default="{}")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--grad", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host (default: the card)")
    args = p.parse_args(argv)
    place = fluid.CPUPlace() if args.cpu else fluid.CUDAPlace(0)

    if args.suite == "resnet50":
        rows = run_suite(resnet50_suite(args.batch or 256),
                         steps=args.steps, place=place)
        print(format_table(rows, "ResNet-50 per-op costs (batch %d)"
                           % (args.batch or 256)))
    elif args.suite == "bert":
        rows = run_suite(bert_suite(args.batch or 64, seq=args.seq or 128),
                         steps=args.steps, place=place)
        print(format_table(rows, "BERT-base per-op costs (batch %d, seq %d)"
                           % (args.batch or 64, args.seq or 128)))
    elif args.suite in ("moe", "attention_moe"):
        rows = run_suite(attention_moe_suite(args.batch or 8,
                                             seq=args.seq or 512),
                         steps=args.steps, place=place)
        print(format_table(rows,
                           "Attention/MoE per-op costs (batch %d, seq %d)"
                           % (args.batch or 8, args.seq or 512)))
    elif args.op:
        spec = {k: v for k, v in json.loads(args.spec or "{}").items()}
        r = bench_op(args.op, spec, json.loads(args.attrs), grad=args.grad,
                     steps=args.steps, place=place)
        print(json.dumps(r))
    else:
        p.error("pass --suite or --op")


if __name__ == "__main__":
    main()
