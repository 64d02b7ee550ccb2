"""Transformer NMT training under pure bf16 (``_amp_dtype = "bfloat16"``,
``_amp_keep = True``, as chip_smoke.py's NMT phases run it) in the port
against paddle_tpu on the CPU: the tiny program of
tests/test_torch_transformer_training.py, with dropout off, JAX's startup
persistables carried across, three Adam steps on the ragged batch there.
Parametrised over ``use_fused_attention``.

What it holds:
- the runtime dtype of every variable the forward and learning-rate ops
  write equals the reference's.  Only the mul and matmul operands are
  cast: each projection's product stays bf16, and adding its float32 bias
  makes q, k and v float32, so ``fused_attention`` runs in float32 in
  both packages; the learning rate, the step counter, ``one_hot`` and
  ``reduce_sum`` stay float32 (a counter or a rate in bf16 would round
  step 257 to 256);
- the fetched learning rate of each step ``rtol 1e-6`` against the
  reference and the closed form, and the counter at 3 after three steps;
- per-step losses within ``rtol 2e-2``, the bf16 loss bound of
  tests/test_torch_resnet_training.py.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import transformer

from test_torch_transformer_training import (COUNTER, LR, STEPS, WARMUP,
                                             build, make_feed, persistables)


def _bf16_program(pkg, mod, fused):
    main, startup, out = build(pkg, mod, mod.tiny_config(
        dropout=0.0, use_fused_attention=fused))
    main._amp_dtype = "bfloat16"
    main._amp_keep = True
    return main, startup, out


def _written(main):
    """Outputs of every op before the first gradient op: the forward
    pass and the learning-rate schedule, in program order."""
    names = []
    for op in main.global_block().ops:
        if op.type.endswith("_grad"):
            break
        for slot in sorted(op.outputs):
            names += [n for n in op.output(slot) if n not in names]
    return names


def _dtype(x):
    """The dtype's name; integers as ``int``: JAX, with 64-bit types off,
    holds an int64 variable as int32."""
    name = str(x.dtype).replace("torch.", "")
    return "int" if name in ("int32", "int64") else name


def _run(pkg, main, scope, out, watch):
    """Per-step losses and learning rates, and the dtypes of ``watch``
    at step 1, fetched as live arrays."""
    exe = pkg.Executor(pkg.CPUPlace())
    lr = out["optimizer"]._global_learning_rate(main).name
    feed = make_feed(out["config"])
    losses, lrs, dtypes = [], [], None
    for step in range(STEPS):
        got = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                      fetch_list=[out["loss"].name, lr] +
                      (watch if step == 0 else []))
        losses.append(float(np.asarray(got[0], np.float32).reshape(-1)[0])
                      if pkg is jfluid else float(got[0].reshape(-1)[0]))
        lrs.append(float(np.asarray(got[1], np.float32).reshape(-1)[0])
                   if pkg is jfluid else float(got[1].reshape(-1)[0]))
        if step == 0:
            dtypes = {n: _dtype(x) for n, x in zip(watch, got[2:])}
            dtypes["loss"], dtypes["lr"] = _dtype(got[0]), _dtype(got[1])
    return losses, lrs, dtypes


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused", "composition"])
def runs(request):
    fused = request.param
    jmain, jstartup, jout = _bf16_program(jfluid, jtransformer, fused)
    pmain, _, pout = _bf16_program(fluid, transformer, fused)
    names = persistables(jmain)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    watch = _written(jmain)
    assert _written(pmain) == watch
    jlosses, jlrs, jdtypes = _run(jfluid, jmain, jscope, jout, watch)
    plosses, plrs, pdtypes = _run(fluid, pmain, pscope, pout, watch)
    return dict(fused=fused, main=pmain, cfg=pout["config"],
                jlosses=jlosses, plosses=plosses, jlrs=jlrs, plrs=plrs,
                jdtypes=jdtypes, pdtypes=pdtypes,
                counters=(np.array(jscope.find_var(COUNTER)),
                          pscope.find_var_numpy(COUNTER)))


def test_bf16_runtime_dtypes_match_the_reference(runs):
    """Every forward and learning-rate variable has the reference's
    dtype; the projections' products are bf16, attention's q, k and v,
    the schedule, one_hot, reduce_sum and the loss float32."""
    assert runs["pdtypes"] == runs["jdtypes"]
    block = runs["main"].global_block()
    ops = [op for op in block.ops if not op.type.endswith("_grad")]

    def dtypes(types, slots, io="input"):
        return {runs["pdtypes"][n] for op in ops if op.type in types
                for s in slots for n in getattr(op, io)(s)
                if n in runs["pdtypes"]}
    assert dtypes(("mul",), ("Out",), "output") == {"bfloat16"}
    assert dtypes(("one_hot", "reduce_sum", "increment", "scale"),
                  ("Out",), "output") == {"float32"}
    assert runs["pdtypes"]["lr"] == runs["pdtypes"]["loss"] == "float32"
    if runs["fused"]:
        n_attn = 3 * runs["cfg"].num_layers
        assert sum(op.type == "fused_attention" for op in ops) == n_attn
        assert dtypes(("fused_attention",), ("Q", "K", "V")) == {"float32"}


def test_bf16_learning_rate_and_counter(runs):
    t = np.arange(1, STEPS + 1, dtype=np.float64)
    want = LR * runs["cfg"].hidden_size ** -0.5 * \
        np.minimum(t ** -0.5, t * WARMUP ** -1.5)
    np.testing.assert_allclose(runs["plrs"], runs["jlrs"], rtol=1e-6)
    np.testing.assert_allclose(runs["plrs"], want, rtol=1e-6)
    for counter in runs["counters"]:
        assert counter.dtype == np.float32
        np.testing.assert_array_equal(counter, [STEPS])


def test_bf16_per_step_losses_match(runs):
    assert np.isfinite(runs["plosses"]).all()
    np.testing.assert_allclose(runs["plosses"], runs["jlosses"], rtol=2e-2)
