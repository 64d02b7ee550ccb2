"""The per-op benchmark in the port (paddle_tpu_torch/fluid/benchmark.py)
against paddle_tpu's (paddle_tpu/fluid/benchmark.py) on the CPU:

- the suites (ResNet-50 at batch 256, BERT-base at batch 64, the
  attention / MoE rows): the same entries, keys, shapes, attrs and
  counts;
- ``_FLOPS_EST`` (and the fwd+bwd = 3x rule) gives the same value for
  the same inputs at every suite entry it covers; the default output
  slots and the fetched slot are the same tables;
- ``bench_op("mul", ..., place=CPUPlace())`` returns JAX's keys with the
  same shape and estimate, plus the ledger's ``counted_flops``;
- ``format_table`` prints the same table for the same rows, and the CLI
  runs with ``--cpu``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import benchmark as jbench

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import benchmark
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(entries):
    """Suite entries with array inputs as (shape, dtype), comparable."""
    out = []
    for e in entries:
        e = dict(e)
        e["inputs"] = {s: (tuple(v.shape), str(v.dtype))
                       if isinstance(v, np.ndarray) else list(v)
                       for s, v in e["inputs"].items()}
        out.append(e)
    return out


SUITES = [("resnet50_suite", (256,), {}),
          ("bert_suite", (64,), {"seq": 128}),
          ("attention_moe_suite", (), {})]


@pytest.mark.parametrize("name,args,kwargs", SUITES)
def test_suites_equal_jax(name, args, kwargs):
    ours = _plain(getattr(benchmark, name)(*args, **kwargs))
    theirs = _plain(getattr(jbench, name)(*args, **kwargs))
    assert ours == theirs
    assert len(ours) > 0


def test_resnet50_suite_counts_every_layer():
    entries = benchmark.resnet50_suite(256)
    convs = sum(e["count"] for e in entries if e["op"] == "conv2d")
    bns = sum(e["count"] for e in entries if e["op"] == "batch_norm")
    assert convs == bns == 53          # 1 stem + 16 x 3 + 4 projections


def _inputs(entry):
    return {s: v if isinstance(v, np.ndarray) else np.zeros(v, np.float32)
            for s, v in entry["inputs"].items()}


def _out_shape(entry):
    """The op's output shape from its inputs, as bench_op reads it."""
    i, a, op = _inputs(entry), entry["attrs"], entry["op"]
    if op == "conv2d":
        n, _, h, w = i["Input"].shape
        o, _, kh, kw = i["Filter"].shape
        s, p = a["strides"][0], a["paddings"][0]
        return (n, o, (h + 2 * p - kh) // s + 1, (w + 2 * p - kw) // s + 1)
    if op == "mul":
        return (i["X"].shape[0], i["Y"].shape[1])
    if op == "matmul":
        x, y = i["X"].shape, i["Y"].shape
        return x[:-1] + (y[-2] if a.get("transpose_Y") else y[-1],)
    if op == "pool2d":
        return i["X"].shape[:2] + (1, 1)
    return i["X"].shape


@pytest.mark.parametrize("name,args,kwargs", SUITES[:2])
def test_flops_estimates_equal_jax(name, args, kwargs):
    assert set(benchmark._FLOPS_EST) == set(jbench._FLOPS_EST)
    n = 0
    for e in getattr(benchmark, name)(*args, **kwargs):
        if e["op"] not in benchmark._FLOPS_EST:
            continue
        i, shape = _inputs(e), _out_shape(e)
        assert benchmark._FLOPS_EST[e["op"]](i, e["attrs"], shape) == \
            jbench._FLOPS_EST[e["op"]](i, e["attrs"], shape), e["key"]
        n += 1
    assert n > 0


def test_output_tables_equal_jax():
    assert benchmark._DEFAULT_OUTPUTS == jbench._DEFAULT_OUTPUTS
    assert benchmark._PRIMARY_OUT == jbench._PRIMARY_OUT


@pytest.mark.parametrize("grad", [False, True])
def test_bench_op_mul_returns_jax_keys(grad):
    spec = {"X": [32, 16], "Y": [16, 8]}
    ours = benchmark.bench_op("mul", spec, grad=grad, steps=4, warmup=1,
                              place=fluid.CPUPlace())
    theirs = jbench.bench_op("mul", spec, grad=grad, steps=4, warmup=1,
                             place=jfluid.CPUPlace())
    assert set(theirs) <= set(ours)
    assert set(ours) - set(theirs) == {"counted_flops"}
    for k in ("op", "out_shape", "grad", "flops"):
        assert ours[k] == theirs[k], k
    # the ledger counts the products the estimate names: forward, and
    # with grad the dX and dY products too (3x)
    assert ours["counted_flops"] == ours["flops"] == \
        2.0 * 32 * 16 * 8 * (3 if grad else 1)
    # the JAX package's bytes rate: inputs and the output once, over ms
    # (both rounded for the row: gbps to 0.01, ms to 1e-4)
    in_out = 4 * (32 * 16 + 16 * 8 + 32 * 8)
    assert ours["ms"] > 0
    assert ours["gbps"] == pytest.approx(
        in_out / (ours["ms"] * 1e-3) / 1e9, rel=1e-3, abs=0.006)


def test_bench_op_skips_gradients_an_op_does_not_have():
    e = benchmark.resnet50_suite(1)[1]
    assert e["op"] == "batch_norm"
    e["inputs"]["X"] = [1, 4, 8, 8]
    for s in ("Scale", "Bias", "Mean", "Variance"):
        e["inputs"][s] = [4]
    r = benchmark.bench_op(e["op"], e["inputs"], e["attrs"], grad=True,
                           steps=2, warmup=1, place=fluid.CPUPlace())
    assert r["out_shape"] == [1, 4, 8, 8]
    assert r["flops"] == 3 * 5.0 * 4 * 64


def test_format_table_equals_jax():
    rows = [{"key": "a", "count": 2, "ms": 1.5, "total_ms": 3.0,
             "tflops": 0.25, "gbps": 10.0},
            {"key": "b", "count": 1, "ms": 0.5, "total_ms": 0.5,
             "gbps": 1.0},
            {"key": "c", "op": "x", "count": 1, "error": "boom",
             "ms": float("nan"), "total_ms": float("nan")}]
    assert benchmark.format_table(rows, "t") == jbench.format_table(rows, "t")


def test_cli_runs_an_op_on_the_cpu():
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.fluid.benchmark", "--cpu",
         "--op", "mul", "--spec", '{"X": [8, 4], "Y": [4, 2]}',
         "--steps", "2"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["op"] == "mul" and r["out_shape"] == [8, 2]
    assert r["counted_flops"] == r["flops"] == 2.0 * 8 * 4 * 2
