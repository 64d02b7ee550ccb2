"""Train-mode dropout, the attention-dropout route and the autograd tape
of the port (paddle_tpu_torch), on the CPU.

The port draws its random bits from torch generators and the JAX package
from ``jax.random`` keys, so the two never give the same mask; dropout
is checked by its law and its algebra instead:
- the keep rate lies within 5 standard deviations of ``1 - p``
  (binomial, n >= 4096 draws);
- kept values are upscaled exactly (``x / (1 - p)``), dropped ones are 0;
- ``dropout_grad`` is ``dOut · Mask / (1 - p)`` for the forward's mask;
- the same program seed and step give the same mask, the next step a
  new one, and ``fix_seed`` one mask for every step.
The attention-dropout route is checked the same way on the dropped
probabilities, read out through ``V = I``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as port_executor
from paddle_tpu_torch.fluid import lowering
from paddle_tpu_torch.fluid.registry import OP_DEFS
from paddle_tpu_torch.models import bert

SHAPE = (64, 320)


def _within_binomial(keep, p):
    n = keep.size
    return abs(keep.mean() - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)


def dropout_program(p, impl="upscale_in_train", seed=None):
    """x → dropout → mean, with backward; x is differentiable."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [SHAPE[1]])
        x.stop_gradient = False
        out = fluid.layers.dropout(x, p, seed=seed,
                                   dropout_implementation=impl)
        loss = fluid.layers.mean(out)
        fluid.append_backward(loss)
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    return main, out, mask


def _x(seed=0):
    return np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_train_mode_dropout_law_scaling_and_grad(impl):
    p = 0.3
    main, out, mask = dropout_program(p, impl)
    exe = fluid.Executor(fluid.CPUPlace())
    x = _x()
    got, m, dx = exe.run(main, feed={"x": x},
                         fetch_list=[out, mask, "x@GRAD"],
                         scope=fluid.Scope())
    assert m.dtype == np.uint8 and set(np.unique(m)) <= {0, 1}
    keep = m.astype(bool)
    assert _within_binomial(keep, p)
    up = 1.0 / (1 - p) if impl == "upscale_in_train" else 1.0
    want = np.where(keep, x / (1 - p) if up != 1.0 else x, 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # loss = mean(out): dOut = 1 / n everywhere
    np.testing.assert_allclose(dx, keep * up / x.size, rtol=1e-6, atol=0)


def test_dropout_masks_follow_seed_and_step():
    main, _, mask = dropout_program(0.5)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    x = {"x": _x()}
    m0, = exe.run(main, feed=x, fetch_list=[mask], scope=scope)
    m1, = exe.run(main, feed=x, fetch_list=[mask], scope=scope)
    again, = exe.run(main, feed=x, fetch_list=[mask], scope=fluid.Scope())
    assert (m0 != m1).any()
    np.testing.assert_array_equal(m0, again)
    fixed, _, fmask = dropout_program(0.5, seed=7)
    scope = fluid.Scope()
    f0, = exe.run(fixed, feed=x, fetch_list=[fmask], scope=scope)
    f1, = exe.run(fixed, feed=x, fetch_list=[fmask], scope=scope)
    np.testing.assert_array_equal(f0, f1)


def attention_dropout_program(p, S=32, H=2):
    """q, k → fused_attention(dropout_prob=p) with V = I, so Out is the
    dropped, upscaled probability matrix itself."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        q, k, v = (fluid.layers.data(n, [H, S, S]) for n in "qkv")
        q.stop_gradient = False
        out = fluid.layers.fused_attention(q, k, v, scale=0.2,
                                           dropout_prob=p)
        fluid.append_backward(fluid.layers.mean(out))
    return main, out


def test_attention_dropout_route_law_and_scaling():
    p, B, H, S = 0.25, 2, 2, 32
    main, out = attention_dropout_program(p, S, H)
    rng = np.random.RandomState(2)
    q, k = (rng.randn(B, H, S, S).astype(np.float32) for _ in range(2))
    feed = {"q": q, "k": k,
            "v": np.broadcast_to(np.eye(S, dtype=np.float32),
                                 (B, H, S, S)).copy()}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    before = fluid.ops.attention_ops.flash_attention.launches
    got, dq = exe.run(main, feed=feed, fetch_list=[out, "q@GRAD"],
                      scope=scope)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * 0.2
    soft = np.exp(s - s.max(-1, keepdims=True))
    soft /= soft.sum(-1, keepdims=True)
    keep = got != 0
    assert _within_binomial(keep, p)
    np.testing.assert_allclose(got[keep], soft[keep] / (1 - p), rtol=1e-5)
    assert dq.shape == q.shape and np.isfinite(dq).all() and \
        np.abs(dq).max() > 0
    nxt, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    again, = exe.run(main, feed=feed, fetch_list=[out], scope=fluid.Scope())
    assert ((nxt != 0) != keep).any()
    np.testing.assert_array_equal(again, got)
    assert fluid.ops.attention_ops.flash_attention.launches == before


class _Recorded(lowering.ExecState):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Recorded.made.append(self)


@pytest.fixture
def recorded(monkeypatch):
    _Recorded.made = []
    monkeypatch.setattr(port_executor, "ExecState", _Recorded)
    return _Recorded.made


def _no_autograd_state(scope):
    return all(not t.requires_grad and t.grad_fn is None
               for t in scope.vars.values())


def test_tape_is_empty_after_run_and_after_a_run_that_raises(recorded,
                                                             monkeypatch):
    main, out, _ = dropout_program(0.2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(main, feed={"x": _x()}, fetch_list=[out], scope=scope)
    assert recorded[-1].tape == {}

    def boom(ctx, op):
        assert ctx.state.tape, "the forward ops should be on the tape"
        raise RuntimeError("injected failure")
    # the loss-gradient seed runs after both taped forward ops
    monkeypatch.setattr(OP_DEFS["fill_constant"], "lower", boom)
    with pytest.raises(RuntimeError, match="injected failure"):
        exe.run(main, feed={"x": _x()}, fetch_list=[out], scope=scope)
    assert recorded[-1].tape == {}
    assert _no_autograd_state(scope)


def test_training_scope_holds_no_autograd_state():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = bert.build_pretrain(bert.tiny_config(num_layers=1),
                                  max_pred_per_seq=2)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    cfg, S = out["config"], out["config"].max_seq_len
    feed = {"src_ids": np.ones((2, S, 1), np.int64),
            "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (2, 1, 1)),
            "sent_ids": np.zeros((2, S, 1), np.int64),
            "input_mask": np.ones((2, S, 1), np.float32),
            "mask_pos": np.array([[1], [2], [S + 3], [S + 4]], np.int32),
            "mask_label": np.array([[5], [6], [7], [8]], np.int64),
            "nsp_label": np.array([[0], [1]], np.int64)}
    loss, = exe.run(main, feed=feed, fetch_list=[out["loss"]], scope=scope,
                    return_numpy=False)
    assert not loss.requires_grad and loss.grad_fn is None
    assert len(scope.vars) > 4 * cfg.num_layers
    assert _no_autograd_state(scope)


def test_inference_clone_records_no_tape(recorded, monkeypatch):
    taped = []
    real = lowering._run_taped
    monkeypatch.setattr(lowering, "_run_taped",
                        lambda *a: taped.append(1) or real(*a))
    main, startup = fluid.Program(), fluid.Program()
    cfg = bert.tiny_config(num_layers=1)
    S = cfg.max_seq_len
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = [fluid.layers.data(n, [S, 1], dtype="float32"
                                  if n == "input_mask" else "int64")
                for n in ("src_ids", "pos_ids", "sent_ids", "input_mask")]
        enc = bert.bert_encoder(*data, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"src_ids": np.ones((2, S, 1), np.int64),
            "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (2, 1, 1)),
            "sent_ids": np.zeros((2, S, 1), np.int64),
            "input_mask": np.ones((2, S, 1), np.float32)}
    got, = exe.run(main.clone(for_test=True), feed=feed, fetch_list=[enc],
                   scope=scope)
    assert np.isfinite(got).all()
    assert taped == [] and recorded[-1].tape == {}
    train, out, _ = dropout_program(0.2)
    exe.run(train, feed={"x": _x()}, fetch_list=[out], scope=fluid.Scope())
    assert len(taped) == 2          # dropout and mean


def test_grad_op_without_its_forward_on_the_tape_raises():
    main, _, _ = dropout_program(0.2)
    block = main.global_block()
    grad_op = [op for op in block.ops if op.type == "dropout_grad"][0]
    state = lowering.ExecState(main.blocks, 0, 0, torch.device("cpu"))
    ctx = lowering.LowerCtx({}, grad_op, state, block)
    with pytest.raises(RuntimeError, match="left no tape entry"):
        lowering.tape_grad_lower(ctx, grad_op)


def test_a_variable_in_two_slots_gets_its_gradient_once():
    """out = x + x: the grad op fills X@GRAD and Y@GRAD for the same
    name; their sum must be d(mean(2x))/dx = 2/n, as the JAX replay
    gives, not twice that."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        x.stop_gradient = False
        dx, = fluid.gradients(fluid.layers.mean(x + x), [x])
    grad_ops = [op for op in main.global_block().ops
                if op.type == "elementwise_add_grad"]
    assert len(grad_ops) == 1 and any(op.type == "sum"
                                      for op in main.global_block().ops)
    got, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": _x()[:4, :8]}, fetch_list=[dx], scope=fluid.Scope())
    np.testing.assert_allclose(got, np.full((4, 8), 2.0 / 32), rtol=1e-6)


def test_unported_optimizer_options_raise_naming_the_roadmap():
    """Per-parameter learning rates and gradient clipping train
    (tests/test_torch_optimizers.py), and so do AMP loss scaling and
    ModelAverage since ROADMAP item 6 was ported
    (tests/test_torch_amp_scaling.py, tests/test_torch_wrapper_
    optimizers.py): loss scaling builds its isfinite gate and
    ModelAverage its conditional reset.  A dygraph schedule (a callable
    learning rate) still raises, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fluid.optimizer.AdamOptimizer(learning_rate=lambda: 0.1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        loss = fluid.layers.mean(fluid.layers.fc(
            x, 2, param_attr=fluid.ParamAttr(learning_rate=0.5)))
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.AdamOptimizer(), init_loss_scaling=128.0)
        opt.minimize(loss)
        ma = fluid.optimizer.ModelAverage(0.15, min_average_window=10,
                                          max_average_window=20)
    kinds = [op.type for op in main.global_block().ops]
    assert kinds.count("isfinite") == 1 and "conditional_block" in kinds
    assert opt.get_loss_scaling() is not None
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed={"x": _x()[:4, :8]}, fetch_list=[loss],
                   scope=scope)
    assert np.isfinite(got).all()
    assert scope.find_var_numpy(ma._count_name)[0] == 1.0
