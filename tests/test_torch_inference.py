"""The port's inference engine (paddle_tpu_torch.fluid.inference, ir.py,
``ServingExecutor.from_inference_model``) on the CPU.

The first tests mirror paddle_tpu's ``tests/test_inference.py`` against
the port at its tolerances: a small conv net (conv2d, batch_norm + relu,
pool2d, fc, softmax) trained 3 SGD steps so the BN statistics are
non-trivial, exported, then

- loaded back and run by the executor: rtol 1e-4 / atol 1e-5 of the
  pruned program's output;
- run by the predictor with the default passes (conv-bn folded, no
  ``batch_norm`` left): rtol 1e-3 / atol 1e-4; ``clone()`` within rtol
  1e-6 of it;
- run by the predictor with ``switch_ir_optim(False)``: rtol 1e-4 /
  atol 1e-5.

Beyond those: on the same export written by paddle_tpu, the port's and
JAX's predictors agree within rtol/atol 1e-5, with the passes and
without; ``delete_dropout_pass`` rewrites dropout as the JAX pass does;
the passes that wait for later items raise naming them; and
``ServingExecutor.from_inference_model`` serves an export, both
parameter layouts, with the rows the executor gives (1e-6).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.inference import (
    AnalysisConfig as JConfig, create_paddle_predictor as jcreate)

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import ir
from paddle_tpu_torch.fluid.inference import (
    AnalysisConfig, Config, PaddleTensor, create_paddle_predictor)
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

CPU = fluid.CPUPlace()


def _convnet(pkg):
    layers = pkg.layers
    img = layers.data(name="img", shape=[1, 12, 12], dtype="float32")
    conv = layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
    bn = layers.batch_norm(conv, act="relu")
    pool = layers.pool2d(bn, pool_size=2, pool_stride=2)
    logits = layers.fc(input=pool, size=3)
    prob = layers.softmax(logits)
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.SGDOptimizer(learning_rate=0.01).minimize(loss)
    return img, prob, loss


def _train_and_save(pkg, exe, scope, model_dir, steps=3):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img, prob, loss = _convnet(pkg)
    rng = np.random.RandomState(0)
    with pkg.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):    # a few steps so BN stats are non-trivial
            exe.run(main, feed={
                "img": rng.randn(8, 1, 12, 12).astype(np.float32),
                "label": rng.randint(0, 3, (8, 1)).astype(np.int64)},
                fetch_list=[loss])
        pkg.io.save_inference_model(model_dir, ["img"], [prob], exe, main)
        infer = pkg.io.prune_program(main, ["img"], [prob.name])
        x = rng.randn(4, 1, 12, 12).astype(np.float32)
        ref, = exe.run(infer, feed={"img": x}, fetch_list=[prob.name])
    return x, np.asarray(ref)


@pytest.fixture(scope="module")
def port_model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port") / "model")
    x, ref = _train_and_save(fluid, fluid.Executor(CPU), fluid.Scope(), d)
    return d, x, ref


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax") / "model")
    x, ref = _train_and_save(jfluid, jfluid.Executor(jfluid.CPUPlace()),
                             jfluid.Scope(), d)
    return d, x, ref


def _cpu_config(model_dir):
    config = AnalysisConfig(model_dir)
    config.disable_gpu()   # the CPU, for the unit test
    return config


def test_save_load_inference_model_roundtrip(port_model):
    model_dir, x, ref = port_model
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(scope):
        prog, feed_names, fetch_vars = fluid.io.load_inference_model(
            model_dir, exe)
    assert feed_names == ["img"]
    out, = exe.run(prog, feed={"img": x}, fetch_list=fetch_vars,
                   scope=scope)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_predictor_matches_executor_and_fuses_bn(port_model):
    model_dir, x, ref = port_model
    pred = create_paddle_predictor(_cpu_config(model_dir))
    out, = pred.run([x])
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)
    types = [op.type for op in pred.program().global_block().ops]
    assert "batch_norm" not in types, types
    assert pred.get_input_names() == ["img"]
    assert len(pred.get_output_names()) == 1
    # clone shares weights and plans and returns identical results
    out2, = pred.clone().run({"img": PaddleTensor(x, name="img")})
    np.testing.assert_allclose(out2, out, rtol=1e-6)


def test_predictor_without_ir_optim(port_model):
    model_dir, x, ref = port_model
    config = _cpu_config(model_dir)
    config.switch_ir_optim(False)
    pred = create_paddle_predictor(config)
    out, = pred.run([x])
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    types = [op.type for op in pred.program().global_block().ops]
    assert "batch_norm" in types  # untouched program


def test_prune_program_drops_training_ops():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img, prob, _ = _convnet(fluid)
    pruned = fluid.io.prune_program(main, ["img"], [prob.name])
    types = [op.type for op in pruned.global_block().ops]
    assert "sgd" not in types and not any(t.endswith("_grad") for t in types)
    assert "conv2d" in types


def test_order_manifest_feeds_the_predictor_positionally(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        z = fluid.layers.data(name="zz", shape=[4], dtype="float32")
        a = fluid.layers.data(name="aa", shape=[3], dtype="float32")
        out = fluid.layers.elementwise_add(fluid.layers.fc(z, size=3), a)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    rng = np.random.RandomState(0)
    zv, av = (rng.randn(2, 4).astype(np.float32),
              rng.randn(2, 3).astype(np.float32))
    d = str(tmp_path / "m")
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["zz", "aa"], [out], exe, main,
                                      params_filename="params")
        want, = exe.run(main, feed={"zz": zv, "aa": av},
                        fetch_list=[out])
    pred = create_paddle_predictor(_cpu_config(d))
    assert pred.get_input_names() == ["zz", "aa"]
    got, = pred.run([zv, av])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ir_optim", [True, False], ids=["passes",
                                                         "no_passes"])
def test_port_and_jax_predictors_agree_on_a_jax_export(jax_model,
                                                       ir_optim):
    model_dir, x, ref = jax_model
    jconfig = JConfig(model_dir)
    jconfig.disable_gpu()
    jconfig.switch_ir_optim(ir_optim)
    want, = jcreate(jconfig).run([x])
    config = _cpu_config(model_dir)
    config.switch_ir_optim(ir_optim)
    pred = create_paddle_predictor(config)
    got, = pred.run([x])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-3 if ir_optim else 1e-4,
                               atol=1e-4 if ir_optim else 1e-5)
    types = [op.type for op in pred.program().global_block().ops]
    assert ("batch_norm" in types) != ir_optim


def test_conv_bn_fuse_pass_folds_like_jax(jax_model):
    """Every weight of both packages' folded programs (the conv filter
    scaled by γ/σ, its bias shifted), from the same export, agrees to
    float32 rounding, and the two programs are the same."""
    model_dir, _, _ = jax_model
    jconfig = JConfig(model_dir)
    jconfig.disable_gpu()
    jpred = jcreate(jconfig)
    pred = create_paddle_predictor(_cpu_config(model_dir))
    assert pred.program().serialize_to_string() == \
        jpred.program().serialize_to_string()
    names = [v.name for v in pred.program().list_vars() if v.persistable
             and pred._scope.find_var(v.name) is not None]
    assert len(names) >= 4
    conv = [op for op in pred.program().global_block().ops
            if op.type == "conv2d"][0]
    assert conv.input("Filter")[0] in names
    for n in names:
        np.testing.assert_allclose(pred._scope.find_var_numpy(n),
                                   np.asarray(jpred._scope.find_var(n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)


def test_delete_dropout_pass_rewrites_like_jax():
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[6], dtype="float32")
            h = pkg.layers.dropout(x, dropout_prob=0.25)
            pkg.layers.dropout(h, dropout_prob=0.5,
                               dropout_implementation="upscale_in_train")
        return main
    from paddle_tpu.fluid import ir as jir
    jprog, prog = build(jfluid), build(fluid)
    jir.delete_dropout_pass(jprog)
    ir.delete_dropout_pass(prog)
    assert [op.type for op in prog.global_block().ops] == ["scale",
                                                          "assign"]
    assert prog.serialize_to_string() == jprog.serialize_to_string()


def test_unported_passes_and_int8_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 13"):
        Config("m").enable_int8()
    with pytest.raises(NotImplementedError, match="item 13"):
        ir.get_pass("int8_execute_pass")(fluid.Program(), fluid.Scope())
    # sync_batch_norm_pass is ported (data parallel): it runs
    prog = fluid.Program()
    assert ir.get_pass("sync_batch_norm_pass")(prog) is prog
    with pytest.raises(KeyError):
        ir.get_pass("no_such_pass")
    c = Config("m")
    assert c.use_gpu() and c.place() == fluid.CUDAPlace(0)
    c.enable_use_gpu(device_id=1)
    assert c.place() == fluid.CUDAPlace(1)
    c.disable_gpu()
    assert c.place() == CPU


# ---------------------------------------------------------------------------
# ServingExecutor.from_inference_model
# ---------------------------------------------------------------------------

FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


@pytest.mark.parametrize("params_filename", [None, "params"])
def test_serving_from_inference_model(tmp_path, params_filename):
    from paddle_tpu_torch.models import bert
    cfg = bert.tiny_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = [fluid.layers.data(n, [cfg.max_seq_len, 1],
                                  dtype="float32" if n == "input_mask"
                                  else "int64") for n in FEEDS]
        enc = bert.bert_encoder(*data, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    d = str(tmp_path / "bert")
    rng = np.random.RandomState(3)
    reqs = []
    for rows in (1, 3, 2, 4):
        S = cfg.max_seq_len
        lengths = rng.randint(1, S + 1, rows)
        reqs.append({
            "src_ids": rng.randint(0, cfg.vocab_size, (rows, S, 1)),
            "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (rows, 1, 1)),
            "sent_ids": rng.randint(0, 2, (rows, S, 1)),
            "input_mask": (np.arange(S)[None, :, None] <
                           lengths[:, None, None]).astype(np.float32)})
    infer = main.clone(for_test=True)
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, list(FEEDS), [enc], exe, main,
                                      params_filename=params_filename)
        alone = [exe.run(infer, feed=r, fetch_list=[enc])[0] for r in reqs]
    sv = fluid.ServingExecutor.from_inference_model(d, place=CPU,
                                                    max_batch=4)
    assert sv.feed_names == list(FEEDS)
    sv.warmup()
    futs = [sv.submit(r) for r in reqs]
    outs = [f.result(timeout=120)[0] for f in futs]
    sv.close()
    st = sv.stats()
    assert st["recompiles"] == 0 and st["responses"] == len(reqs)
    for got, want in zip(outs, alone):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
