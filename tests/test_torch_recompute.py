"""RecomputeOptimizer and the ``recompute`` op in the port
(paddle_tpu_torch), against paddle_tpu on the CPU and against the port's
own plain program (the JAX package's tests/test_recompute.py cases):

- a 4-layer MLP with a checkpoint: the same main program as JAX's (the
  ``recompute`` op first, its sub-block, ``recompute_grad``); losses
  bit-equal to the port's program without recompute and ``rtol 1e-5``
  against JAX's; the span's forward rules run again in the backward
  (the replay) and its intermediates never reach the environment;
- dropout inside the span: the replay draws the forward's mask, so
  the losses are bit-equal to the plain program's and run to run;
- batch norm inside the span: the running statistics update once per
  step, bit-equal to the plain program and ``rtol 1e-5, atol 1e-6``
  against JAX's;
- a stop_gradient variable inside the span: the gradient cut as
  without recompute (bit-equal losses), and JAX's losses ``rtol 1e-5``;
- recompute under pure-bf16 AMP with dynamic loss scaling: losses
  bit-equal to the same AMP program without recompute, JAX's ``rtol
  2e-2``;
- tiny BERT (2 layers, the fused-attention route) with the post-FFN
  layer_norm outputs as checkpoints, Adam, 3 steps: losses bit-equal to
  the plain program's and ``rtol 1e-5`` against JAX's, parameters
  ``1e-4`` relative L2 against JAX's; per step the flash forward runs
  twice per layer (forward and replay) and each backward once;
- no checkpoints: ValueError, as in JAX.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.contrib import mixed_precision as jamp
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.contrib import mixed_precision as amp
from paddle_tpu_torch.fluid.ops import attention_ops
from paddle_tpu_torch.fluid.registry import OP_DEFS
from paddle_tpu_torch.models import bert
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

AMP = {jfluid: jamp, fluid: amp}


def _mlp(pkg, recompute, dropout=False, bn=False, stop=False, wrap=None):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data(name="x", shape=[16], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h1 = L.fc(x, size=32, act="relu")
        if bn:
            h1 = L.relu(L.batch_norm(L.fc(x, size=32)))
        if dropout:
            h1 = L.dropout(h1, dropout_prob=0.3)
        if stop:
            detached = L.scale(h1, scale=2.0)
            detached.stop_gradient = True
            h1 = h1 + detached
        h2 = L.fc(h1, size=32, act="relu")
        h3 = L.fc(h2, size=32, act="relu")
        pred = L.fc(h3, size=1)
        loss = L.mean(L.square_error_cost(pred, y))
        opt = pkg.optimizer.SGDOptimizer(0.05)
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h2])
        if wrap is not None:
            opt = wrap(pkg, opt)
        opt.minimize(loss)
    return main, startup, loss


def _feed(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return {"x": (rng.randn(n, 16) * 2 + 0.5).astype(np.float32),
            "y": rng.randn(n, 1).astype(np.float32)}


def _train(pkg, main, startup, loss, init=None, steps=4, extra=()):
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    if init is not None:
        fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    start = {n: np.array(scope.find_var(n)) for n in names}
    losses = [float(np.asarray(exe.run(main, feed=_feed(), fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    after = {n: np.array(scope.find_var_numpy(n) if pkg is fluid
                         else scope.find_var(n)) for n in names}
    return losses, start, after


def _both(**kw):
    """JAX with recompute, the port with and without, from JAX's
    startup state."""
    jl, init, jafter = _train(jfluid, *_mlp(jfluid, True, **kw))
    pr = _train(fluid, *_mlp(fluid, True, **kw), init=init)
    pp = _train(fluid, *_mlp(fluid, False, **kw), init=init)
    return (jl, jafter), pr, pp


def _ops(prog):
    return [[(op.type, op.inputs, op.outputs, op.attrs) for op in b.ops]
            for b in prog.blocks]


def test_recompute_program_and_losses_match_jax(monkeypatch):
    jmain = _mlp(jfluid, True)[0]
    main, startup, loss = _mlp(fluid, True)
    assert _ops(main) == _ops(jmain)
    kinds = [op.type for op in main.global_block().ops]
    assert kinds.index("recompute") == 0 and "recompute_grad" in kinds
    rec = main.global_block().ops[0]
    assert [op.type for op in main.blocks[rec.attr("sub_block")].ops] == \
        ["mul", "elementwise_add", "relu", "mul", "elementwise_add", "relu"]
    # the span's relus run in the forward and again in the replay
    calls = []
    relu = OP_DEFS["relu"]
    monkeypatch.setattr(relu, "lower",
                        lambda ctx, op, f=relu.lower: (calls.append(1),
                                                       f(ctx, op))[1])
    (jl, _ja), (rl, _s, _ra), (pl, _s2, _pa) = _both()
    assert len(calls) == 4 * (2 + 2 + 1) + 4 * 3
    assert rl == pl
    np.testing.assert_allclose(rl, jl, rtol=1e-5)
    assert rl[-1] < rl[0]


def test_recompute_keeps_no_span_intermediate():
    main, startup, loss = _mlp(fluid, True)
    sub = main.blocks[main.global_block().ops[0].attr("sub_block")]
    inner = {n for op in sub.ops for names in op.outputs.values()
             for n in names} - set(main.global_block().ops[0].output("Out"))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(KeyError, match="not produced"):
        exe.run(main, feed=_feed(), fetch_list=[sorted(inner)[0]],
                scope=scope)


def test_recompute_with_dropout_in_span_replays_the_mask():
    init = _train(jfluid, *_mlp(jfluid, True, dropout=True))[1]
    a = _train(fluid, *_mlp(fluid, True, dropout=True), init=init)
    b = _train(fluid, *_mlp(fluid, True, dropout=True), init=init)
    base = _train(fluid, *_mlp(fluid, False, dropout=True), init=init)
    assert a[0] == b[0] == base[0]
    for n in a[2]:
        np.testing.assert_array_equal(a[2][n], base[2][n], err_msg=n)
    assert a[0][-1] < a[0][0]


def test_recompute_preserves_bn_running_stats():
    (jl, jafter), (rl, _s, rafter), (pl, _s2, pafter) = _both(bn=True)
    assert rl == pl
    np.testing.assert_allclose(rl, jl, rtol=1e-5)
    means = [n for n in rafter if n.endswith(".mean") or
             n.endswith(".variance") or "_mean" in n or "_variance" in n]
    assert means
    for n in means:
        np.testing.assert_array_equal(rafter[n], pafter[n], err_msg=n)
        np.testing.assert_allclose(rafter[n], jafter[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    assert max(np.abs(rafter[n]).max() for n in means) > 1e-3


def test_recompute_respects_stop_gradient():
    main = _mlp(fluid, True, stop=True)[0]
    stops = main.global_block().ops[0].attr("stop_gradient_vars")
    assert len(stops) == 1
    (jl, _j), (rl, _s, _r), (pl, _s2, _p) = _both(stop=True)
    assert rl == pl
    np.testing.assert_allclose(rl, jl, rtol=1e-5)


def test_recompute_composes_with_amp_loss_scaling():
    def wrap(pkg, opt):
        return AMP[pkg].decorate(opt, use_pure_bf16=True,
                                 use_dynamic_loss_scaling=True,
                                 init_loss_scaling=2.0 ** 10)
    jl, init, _ja = _train(jfluid, *_mlp(jfluid, True, wrap=wrap), steps=6)
    rl = _train(fluid, *_mlp(fluid, True, wrap=wrap), init=init, steps=6)[0]
    pl = _train(fluid, *_mlp(fluid, False, wrap=wrap), init=init, steps=6)[0]
    assert rl == pl
    assert np.isfinite(rl).all() and rl[-1] < rl[0]
    np.testing.assert_allclose(rl, jl, rtol=2e-2)


def test_recompute_requires_checkpoints():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, size=1))
        opt = fluid.optimizer.RecomputeOptimizer(
            fluid.optimizer.SGDOptimizer(0.1))
        with pytest.raises(ValueError):
            opt.minimize(loss)


# ---------------------------------------------------------------------------
# tiny BERT: the fused-attention route inside a recompute span
# ---------------------------------------------------------------------------

class EncoderCheckpoints:
    """An optimizer for build_pretrain that wraps ``inner`` in
    RecomputeOptimizer with each encoder layer's post-FFN layer_norm
    output as a checkpoint."""

    def __init__(self, pkg, inner, layers):
        self.pkg, self.inner, self.layers = pkg, inner, layers

    def minimize(self, loss):
        lns = [op.output("Y")[0] for op in loss.block.program
               .global_block().ops if op.type == "layer_norm"]
        opt = self.pkg.optimizer.RecomputeOptimizer(self.inner)
        opt._set_checkpoints(lns[2:2 * self.layers + 1:2])
        return opt.minimize(loss)


def _bert_feed(cfg, n=4, n_pred=4, seed=0):
    rng = np.random.RandomState(seed)
    S = cfg.max_seq_len
    lengths = rng.randint(S // 2, S + 1, n)
    pos = np.stack([rng.choice(k, n_pred, replace=False) + i * S
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
                                  (n * n_pred, 1)).astype(np.int64),
        "nsp_label": rng.randint(0, 2, (n, 1)).astype(np.int64)}


def _bert_run(pkg, mod, recompute, init=None, steps=3):
    cfg = mod.tiny_config(hidden_dropout=0.0, attn_dropout=0.0)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        inner = pkg.optimizer.AdamOptimizer(1e-3)
        opt = EncoderCheckpoints(pkg, inner, cfg.num_layers) if recompute \
            else inner
        out = mod.build_pretrain(cfg, max_pred_per_seq=4, optimizer=opt)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    if init is None:
        init = {n: np.array(scope.find_var(n)) for n in names}
    else:
        fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    feed = _bert_feed(cfg)
    losses = [float(np.asarray(exe.run(main, feed=feed,
                                       fetch_list=[out["loss"]],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(steps)]
    after = {n: np.array(scope.find_var_numpy(n) if pkg is fluid
                         else scope.find_var(n)) for n in names}
    return dict(main=main, losses=losses, init=init, after=after, cfg=cfg)


def test_tiny_bert_recompute_matches_plain_and_jax(monkeypatch):
    j = _bert_run(jfluid, jbert, True)
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for key, name in (("fwd", "flash_attention"),
                      ("dq", "flash_attention_bwd_dq"),
                      ("dkv", "flash_attention_bwd_dkv")):
        real = getattr(attention_ops, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(attention_ops, name, counted)
    p = _bert_run(fluid, bert, True, init=j["init"])
    per_step = {k: v / 3 for k, v in calls.items()}
    monkeypatch.undo()
    plain = _bert_run(fluid, bert, False, init=j["init"])
    L = p["cfg"].num_layers
    kinds = [op.type for op in p["main"].global_block().ops]
    assert kinds.count("recompute") == L
    assert "fused_attention" not in kinds
    assert per_step == {"fwd": 2 * L, "dq": L, "dkv": L}
    assert p["losses"] == plain["losses"]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=1e-5)
    for n in j["after"]:
        a, b = p["after"][n].astype(np.float64), j["after"][n]
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel <= 1e-4 or np.abs(a - b).max() <= 1e-7, (n, rel)
