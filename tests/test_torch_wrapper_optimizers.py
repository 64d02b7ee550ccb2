"""The wrapper optimizers and the DGC/proximal rules of the port
(paddle_tpu_torch), each against paddle_tpu on the CPU:

- ``dgc_momentum`` on hand-built programs over five steps (two before
  ``rampup_begin_step``, then the rampup schedule), with tied
  magnitudes at the threshold: Param, U and V after every step ``rtol
  1e-6, atol 1e-7``; ``proximal_gd`` and ``proximal_adagrad`` with
  ``l1 > 0`` and ``l1 = 0``, and ``average_accumulates`` over a window
  that drains: every output ``rtol 1e-6, atol 1e-7`` (counters exactly);
- on a linear regression as the JAX package's tests train it, from
  JAX's startup state: ExponentialMovingAverage, ModelAverage (its
  window reset firing), LookaheadOptimizer, DGCMomentumOptimizer (plain
  momentum before rampup, sparsified after) and GradientMergeOptimizer
  (SGD and Adam): the same main and startup programs op for op, the
  per-step losses ``rtol 1e-5`` and every persistable after each step
  ``rtol 1e-5, atol 1e-6``; ``apply``/``restore`` against JAX's and
  against the closed forms (the bias-corrected EMA, the window mean);
  the restored parameters bit-equal to the trained ones;
- GradientMerge's parameters bit-unchanged between applies, its
  accumulators and the inner Adam's state in the global block;
- tiny BERT (2 layers, the fused-attention route) through
  GradientMergeOptimizer(Adam, k_steps=2) against paddle_tpu: losses
  ``rtol 1e-5``, parameters ``1e-4`` relative L2 after each apply;
- GradAllReduce adds no all-reduce for a DGC parameter.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import bert
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7
PKGS = (jfluid, fluid)


def _set_state(pkg, scope, arrays):
    if pkg is fluid:
        fluid.load_numpy_params(scope, arrays, fluid.CPUPlace())
    else:
        for n, a in arrays.items():
            scope.set_var(n, a)


def _get(pkg, scope, name):
    if pkg is fluid:
        return scope.find_var_numpy(name)
    return np.asarray(scope.find_var(name))


# ---------------------------------------------------------------------------
# the op rules on hand-built programs
# ---------------------------------------------------------------------------

def _op_program(pkg, op_type, arrays, outputs, attrs):
    main = pkg.Program()
    block = main.global_block()
    for n, a in arrays.items():
        block.create_var(name=n, shape=a.shape, dtype=str(a.dtype),
                         persistable=True)
    block.append_op(op_type, inputs={n: [n] for n in arrays},
                    outputs=outputs, attrs=attrs)
    return main


def _run_op_steps(pkg, op_type, arrays, outputs, attrs, steps, read):
    main = _op_program(pkg, op_type, arrays, outputs, attrs)
    scope = pkg.Scope()
    _set_state(pkg, scope, arrays)
    exe = pkg.Executor(pkg.CPUPlace())
    got = []
    for _ in range(steps):
        exe.run(main, scope=scope)
        got.append({n: _get(pkg, scope, n) for n in read})
    return got


def _dgc_arrays(seed):
    rng = np.random.RandomState(seed)
    shape = (6, 5)
    g = rng.randn(*shape).astype(np.float32)
    g[0, :3] = 0.75          # tied magnitudes at the threshold
    g[1, :2] = -0.75
    return {"Param": rng.randn(*shape).astype(np.float32), "Grad": g,
            "U": (0.1 * rng.randn(*shape)).astype(np.float32),
            "V": (0.1 * rng.randn(*shape)).astype(np.float32),
            "LearningRate": np.array([0.05], np.float32)}


@pytest.mark.parametrize("begin,rampup", [(2, 3), (0, 1)])
def test_dgc_momentum_rule_matches_jax(begin, rampup):
    arrays = _dgc_arrays(3)
    attrs = {"momentum": 0.9, "rampup_begin_step": begin,
             "rampup_step": rampup,
             "sparsity": [0.5, 0.75, 0.9, 0.999]}
    outputs = {"ParamOut": ["Param"], "UOut": ["U"], "VOut": ["V"]}
    want, got = (_run_op_steps(pkg, "dgc_momentum", arrays, outputs, attrs,
                               5, ("Param", "U", "V")) for pkg in PKGS)
    for step, (w, g) in enumerate(zip(want, got)):
        for n in w:
            np.testing.assert_allclose(g[n], w[n], rtol=RTOL, atol=ATOL,
                                       err_msg="%s step %d" % (n, step))
    if begin == 2:
        # before rampup u is zeroed; after, the sent entries are cleared
        np.testing.assert_array_equal(got[0]["U"], 0)
        assert (got[3]["V"] == 0).sum() > 0


@pytest.mark.parametrize("l1", [0.0, 0.05])
@pytest.mark.parametrize("op_type", ["proximal_gd", "proximal_adagrad"])
def test_proximal_rules_match_jax(op_type, l1):
    rng = np.random.RandomState(4)
    arrays = {"Param": (0.1 * rng.randn(6, 5)).astype(np.float32),
              "Grad": rng.randn(6, 5).astype(np.float32),
              "LearningRate": np.array([0.1], np.float32)}
    outputs = {"ParamOut": ["Param"]}
    read = ["Param"]
    if op_type == "proximal_adagrad":
        arrays["Moment"] = rng.uniform(0.5, 2, (6, 5)).astype(np.float32)
        outputs["MomentOut"] = ["Moment"]
        read.append("Moment")
    attrs = {"l1": l1, "l2": 0.02}
    want, got = (_run_op_steps(pkg, op_type, arrays, outputs, attrs, 2, read)
                 for pkg in PKGS)
    for w, g in zip(want, got):
        for n in w:
            np.testing.assert_allclose(g[n], w[n], rtol=RTOL, atol=ATOL,
                                       err_msg=n)
    if l1 > 0:
        # the soft threshold sets the small entries to exactly 0
        assert (got[0]["Param"] == 0).sum() > 0


def test_average_accumulates_rule_matches_jax():
    rng = np.random.RandomState(5)
    arrays = {"param": rng.randn(4, 3).astype(np.float32)}
    for n in ("in_sum_1", "in_sum_2", "in_sum_3"):
        arrays[n] = np.zeros((4, 3), np.float32)
    for n in ("in_num_accumulates", "in_old_num_accumulates",
              "in_num_updates"):
        arrays[n] = np.zeros((1,), np.int32)
    outputs = {"out_" + n[3:]: [n] for n in arrays if n.startswith("in_")}
    attrs = {"average_window": 0.5, "min_average_window": 2,
             "max_average_window": 3}
    read = [n for n in arrays if n.startswith("in_")]
    want, got = (_run_op_steps(pkg, "average_accumulates", arrays, outputs,
                               attrs, 7, read) for pkg in PKGS)
    drained = 0
    for w, g in zip(want, got):
        for n in w:
            if "num" in n:
                np.testing.assert_array_equal(g[n], w[n], err_msg=n)
            else:
                np.testing.assert_allclose(g[n], w[n], rtol=RTOL, atol=ATOL,
                                           err_msg=n)
        drained += int(g["in_num_accumulates"][0] == 0)
    assert drained >= 2


# ---------------------------------------------------------------------------
# the wrapper classes on a linear regression, against paddle_tpu
# ---------------------------------------------------------------------------

def _data(n=32, d=8, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    ws = rng.normal(size=(d, 1)).astype(np.float32)
    return xs, (xs @ ws).astype(np.float32)


def _linreg(pkg, d=8):
    L = pkg.layers
    x = L.data(name="x", shape=[d], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    h = L.fc(x, size=4, act="tanh",
             param_attr=pkg.ParamAttr(
                 name="w0", initializer=pkg.initializer.UniformInitializer(
                     -0.5, 0.5, seed=3)))
    pred = L.fc(h, size=1,
                param_attr=pkg.ParamAttr(
                    name="w", initializer=pkg.initializer.ConstantInitializer(
                        0.1)))
    return L.mean(L.square_error_cost(pred, y))


def _ops(prog):
    return [[(op.type, op.inputs, op.outputs, op.attrs) for op in b.ops]
            for b in prog.blocks]


def _vars(prog):
    return {n: (v.shape, v.dtype, v.persistable)
            for n, v in prog.global_block().vars.items()}


def _build(pkg, wrap):
    """``wrap(pkg, loss)`` appends the optimizer and returns its handle."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = _linreg(pkg)
        handle = wrap(pkg, loss)
    return main, startup, loss, handle


def train_both(wrap, feeds, fetch_extra=()):
    """Both packages from JAX's startup state; per step the loss and
    every persistable of the main program."""
    out, init = {}, None
    for pkg in PKGS:
        main, startup, loss, handle = _build(pkg, wrap)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        # both run the startup (the step counter, which DGC's rampup
        # reads, then agrees), and the port takes JAX's state
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: np.array(scope.find_var(n)) for n in names
                    if scope.find_var(n) is not None}
        else:
            _set_state(pkg, scope, init)
        losses, states = [], []
        for feed in feeds:
            got = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
            states.append({n: _get(pkg, scope, n) for n in names})
        out[pkg] = dict(main=main, startup=startup, losses=losses,
                        states=states, handle=handle, scope=scope, exe=exe,
                        init=init)
    return out[jfluid], out[fluid]


def _check_both(j, p):
    assert _ops(p["main"]) == _ops(j["main"])
    assert _ops(p["startup"]) == _ops(j["startup"])
    assert _vars(p["main"]) == _vars(j["main"])
    assert np.isfinite(p["losses"]).all()
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5)
    for step, (sj, sp) in enumerate(zip(j["states"], p["states"])):
        assert sorted(sj) == sorted(sp)
        for n in sj:
            np.testing.assert_allclose(sp[n], sj[n], rtol=1e-5, atol=1e-6,
                                       err_msg="%s step %d" % (n, step))


def _sgd_then(make):
    def wrap(pkg, loss):
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
        return make(pkg)
    return wrap


def test_ema_matches_jax_and_the_bias_corrected_closed_form():
    xs, ys = _data(seed=5)
    feeds = [{"x": xs, "y": ys}] * 6

    def make(pkg):
        ema = pkg.optimizer.ExponentialMovingAverage(decay=0.9)
        ema.update()
        return ema
    j, p = train_both(_sgd_then(make), feeds)
    _check_both(j, p)
    hist = [s["w0"] for s in p["states"]]
    shadow = np.zeros_like(hist[0], np.float64)
    for w in hist:
        shadow = 0.9 * shadow + 0.1 * w
    want = shadow / (1.0 - 0.9 ** len(hist))
    applied = {}
    for side in (j, p):
        pkg = jfluid if side is j else fluid
        trained = _get(pkg, side["scope"], "w0").copy()
        with pkg.scope_guard(side["scope"]):
            with side["handle"].apply(side["exe"]):
                applied[pkg] = _get(pkg, side["scope"], "w0").copy()
        np.testing.assert_array_equal(_get(pkg, side["scope"], "w0"),
                                      trained)
    np.testing.assert_allclose(applied[fluid], applied[jfluid], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(applied[fluid], want, rtol=1e-4, atol=1e-6)


def test_model_average_window_reset_matches_jax():
    """max_average_window=2: the count passes it at step 3 and the
    conditional block resets sum and count; apply installs sum/count."""
    xs, ys = _data(seed=7)
    feeds = [{"x": xs, "y": ys}] * 5

    def make(pkg):
        return pkg.optimizer.ModelAverage(0.15, max_average_window=2)
    j, p = train_both(_sgd_then(make), feeds)
    _check_both(j, p)
    counts = [float(s["ma_count_0"][0]) for s in p["states"]]
    assert counts == [1.0, 2.0, 1.0, 2.0, 1.0]
    hist = [s["w0"] for s in p["states"]]
    applied = {}
    for side in (j, p):
        pkg = jfluid if side is j else fluid
        trained = _get(pkg, side["scope"], "w0").copy()
        with pkg.scope_guard(side["scope"]):
            with side["handle"].apply(side["exe"]):
                applied[pkg] = _get(pkg, side["scope"], "w0").copy()
        np.testing.assert_array_equal(_get(pkg, side["scope"], "w0"),
                                      trained)
    np.testing.assert_allclose(applied[fluid], applied[jfluid], rtol=1e-5,
                               atol=1e-6)
    # after the reset at step 5 the window holds step 5's value alone
    np.testing.assert_allclose(applied[fluid], hist[-1], rtol=1e-6)


def test_lookahead_matches_jax_and_syncs_every_k():
    xs, ys = _data(seed=6)
    feeds = [{"x": xs, "y": ys}] * 6

    def wrap(pkg, loss):
        return pkg.optimizer.LookaheadOptimizer(
            pkg.optimizer.SGDOptimizer(0.1), alpha=0.5, k=3).minimize(loss)
    j, p = train_both(wrap, feeds)
    _check_both(j, p)
    np.testing.assert_array_equal(p["init"]["w0_la_slow"], p["init"]["w0"])
    for step, s in enumerate(p["states"], 1):
        synced = np.array_equal(s["w0"], s["w0_la_slow"])
        assert synced == (step % 3 == 0), step


@pytest.mark.parametrize("begin", [1000, 2])
def test_dgc_optimizer_matches_jax(begin):
    xs, ys = _data(seed=3)
    feeds = [{"x": xs, "y": ys}] * 5

    def wrap(pkg, loss):
        return pkg.optimizer.DGCMomentumOptimizer(
            0.05, momentum=0.9, rampup_begin_step=begin,
            rampup_step=2).minimize(loss)
    j, p = train_both(wrap, feeds)
    _check_both(j, p)
    assert p["main"]._dgc_param_names == {"w0", "w", "fc_0.b_0",
                                          "fc_1.b_0"}
    if begin == 1000:
        # before rampup it is plain momentum
        _jm, pm = train_both(
            lambda pkg, loss: pkg.optimizer.MomentumOptimizer(
                0.05, momentum=0.9).minimize(loss), feeds)
        np.testing.assert_allclose(p["losses"], pm["losses"], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_gradient_merge_matches_jax(inner):
    """k=4 over four 8-row micro-batches, 8 runs: two applies."""
    rng = np.random.RandomState(5)
    xs = rng.normal(size=(32, 8)).astype(np.float32)
    ys = rng.normal(size=(32, 1)).astype(np.float32)
    feeds = [{"x": xs[(s % 4) * 8:(s % 4) * 8 + 8],
              "y": ys[(s % 4) * 8:(s % 4) * 8 + 8]} for s in range(8)]

    def wrap(pkg, loss):
        opt = pkg.optimizer.SGDOptimizer(0.1) if inner == "sgd" else \
            pkg.optimizer.AdamOptimizer(0.01)
        return pkg.optimizer.GradientMergeOptimizer(opt, k_steps=4) \
            .minimize(loss)
    j, p = train_both(wrap, feeds)
    _check_both(j, p)
    main = p["main"]
    gb = main.global_block()
    # the inner optimizer's ops are in the sub-block, its state global
    sub = main.blocks[1]
    kinds = [op.type for op in sub.ops]
    assert kinds.count(inner) == 4
    lr = [op.input("LearningRate")[0] for op in sub.ops
          if op.type == inner][0]
    state = ["w0_gm_acc_0", lr] + (
        [op.input("Moment1")[0] for op in sub.ops if op.type == "adam"]
        if inner == "adam" else [])
    for n in state:
        assert gb.has_var_local(n) and not sub.has_var_local(n), n
    states = p["states"]
    for s in (0, 1, 2, 4, 5, 6):
        before = p["init"] if s == 0 else states[s - 1]
        np.testing.assert_array_equal(states[s]["w0"], before["w0"])
    assert not np.array_equal(states[3]["w0"], states[2]["w0"])
    # the averaged accumulation is one big-batch SGD step
    if inner == "sgd":
        main_s, startup_s, loss_s, _h = _build(
            fluid, lambda pkg, loss: pkg.optimizer.SGDOptimizer(0.1)
            .minimize(loss))
        scope = fluid.Scope()
        _set_state(fluid, scope, {n: v for n, v in p["init"].items()
                                  if main_s.global_block().has_var(n)})
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(main_s, feed={"x": xs, "y": ys}, fetch_list=[loss_s],
                scope=scope)
        np.testing.assert_allclose(states[3]["w0"],
                                   scope.find_var_numpy("w0"),
                                   rtol=1e-5, atol=1e-6)


def test_grad_allreduce_skips_dgc_parameters():
    from paddle_tpu.fluid.transpiler import GradAllReduce as JGAR
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    progs = {}
    for pkg, gar in ((jfluid, JGAR), (fluid, GradAllReduce)):
        main, startup, loss, _h = _build(
            pkg, lambda pkg, loss: pkg.optimizer.DGCMomentumOptimizer(
                0.05, momentum=0.9, rampup_begin_step=0).minimize(loss))
        gar().transpile(startup_program=startup, main_program=main,
                        rank=0, endpoints=["a", "b"])
        progs[pkg] = main
    kinds = [op.type for op in progs[fluid].global_block().ops]
    assert kinds.count("c_allreduce_sum") == 0
    assert kinds.count("dgc_momentum") == 4
    assert _ops(progs[fluid]) == _ops(progs[jfluid])
    # a mixed program: only the non-DGC parameter's gradient is reduced
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = _linreg(fluid)
        params_grads = fluid.optimizer.SGDOptimizer(0.1).backward(loss)
        dgc = fluid.optimizer.DGCMomentumOptimizer(
            0.05, momentum=0.9, rampup_begin_step=0)
        dgc.apply_gradients([pg for pg in params_grads
                             if pg[0].name != "w"])
        fluid.optimizer.SGDOptimizer(0.1).apply_gradients(
            [pg for pg in params_grads if pg[0].name == "w"])
    GradAllReduce(fuse_grad_size_mb=0).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["a", "b"])
    reduced = [op.input("X")[0] for op in main.global_block().ops
               if op.type == "c_allreduce_sum"]
    assert reduced == ["w@GRAD"]


# ---------------------------------------------------------------------------
# tiny BERT through GradientMergeOptimizer
# ---------------------------------------------------------------------------

BERT_ROWS, BERT_PRED = 4, 4


def _bert_feed(cfg, n, seed):
    rng = np.random.RandomState(seed)
    S = cfg.max_seq_len
    lengths = rng.randint(S // 2, S + 1, n)
    pos = np.stack([rng.choice(k, BERT_PRED, replace=False) + i * S
                    for i, k in enumerate(lengths)])
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (n, S, 1)).astype(np.int64),
        "pos_ids": np.tile(np.arange(S).reshape(1, S, 1),
                           (n, 1, 1)).astype(np.int64),
        "sent_ids": rng.randint(0, 2, (n, S, 1)).astype(np.int64),
        "input_mask": (np.arange(S)[None, :, None] <
                       lengths[:, None, None]).astype(np.float32),
        "mask_pos": pos.reshape(-1, 1).astype(np.int32),
        "mask_label": rng.randint(0, cfg.vocab_size,
                                  (n * BERT_PRED, 1)).astype(np.int64),
        "nsp_label": rng.randint(0, 2, (n, 1)).astype(np.int64)}


def bert_both(make_opt, feeds, cfg_kw=None):
    """Tiny BERT (dropout off) in both packages from JAX's startup state;
    the losses and every persistable after each run."""
    out, init = {}, None
    for pkg, mod in ((jfluid, jbert), (fluid, bert)):
        cfg = mod.tiny_config(hidden_dropout=0.0, attn_dropout=0.0,
                              **(cfg_kw or {}))
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            res = mod.build_pretrain(cfg, max_pred_per_seq=BERT_PRED,
                                     optimizer=make_opt(pkg))
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        # both run the startup (the step counter, which DGC's rampup
        # reads, then agrees), and the port takes JAX's state
        exe.run(startup, scope=scope)
        if init is None:
            init = {n: np.array(scope.find_var(n)) for n in names
                    if scope.find_var(n) is not None}
        else:
            _set_state(pkg, scope, init)
        losses, states = [], []
        for feed in feeds:
            got = exe.run(main, feed=feed, fetch_list=[res["loss"]],
                          scope=scope)
            losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
            states.append({n: _get(pkg, scope, n) for n in names})
        out[pkg] = dict(main=main, losses=losses, states=states, init=init,
                        names=names)
    return out[jfluid], out[fluid]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_tiny_bert_gradient_merge_matches_jax():
    cfg = bert.tiny_config()
    feeds = [_bert_feed(cfg, BERT_ROWS, s % 2) for s in range(4)]
    j, p = bert_both(lambda pkg: pkg.optimizer.GradientMergeOptimizer(
        pkg.optimizer.AdamOptimizer(1e-3), k_steps=2), feeds)
    assert "fused_attention" in [op.type for op in
                                 p["main"].global_block().ops]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5)
    params = [n for n in p["names"] if n in p["init"] and
              "moment" not in n and "pow_acc" not in n and
              "gm_" not in n and "learning_rate" not in n]
    for step in (1, 3):
        for n in params:
            sj, sp = j["states"][step][n], p["states"][step][n]
            assert _rel_l2(sp, sj) <= 1e-4 or \
                np.abs(sp - sj).max() <= 1e-7, (n, step)
    for n in params:
        np.testing.assert_array_equal(p["states"][0][n], p["init"][n])
        np.testing.assert_array_equal(p["states"][2][n], p["states"][1][n])
