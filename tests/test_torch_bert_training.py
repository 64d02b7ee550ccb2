"""BERT pretraining in the port (paddle_tpu_torch) against paddle_tpu on
the CPU: the same tiny program (``tiny_config`` with dropout off, 2
layers, width 64, 4 heads, S=32; ``max_pred_per_seq=4``, batch 4, Adam
at lr 1e-3) built in both packages, JAX's startup persistables
(parameters, Adam moments, beta powers, learning rate) carried into the
port's scope with ``load_numpy_params``, then three Adam steps on one
numpy batch.  JAX runs its flash attention (forward and the three
backward kernels) in Pallas interpret mode; the port runs
``FlashAttentionFunction`` with the plain versions of its kernels.

Tolerances, float32 throughout:
- per-step losses ``rtol 1e-4``;
- step-1 parameter gradients ``|Δ| <= 1e-3·max|g| + 1e-9``: relative to
  the tensor's largest entry, plus an absolute floor for the key
  projections' biases, whose gradient is 0 in exact arithmetic (a bias
  on k shifts a whole score row, which softmax ignores) and is rounding
  noise of ~1e-12 in both packages;
- parameters after step 3 ``atol 1e-5``.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.ops import attention_ops as port_attn
from paddle_tpu_torch.models import bert
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

B, P, LR, STEPS = 4, 4, 1e-3, 3


def build(pkg, bert_mod, **kw):
    kw.setdefault("hidden_dropout", 0.0)
    kw.setdefault("attn_dropout", 0.0)
    cfg = bert_mod.tiny_config(**kw)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = bert_mod.build_pretrain(cfg, lr=LR, max_pred_per_seq=P)
    return main, startup, out


def make_feed(cfg, batch=B, preds=P, seed=0):
    """A synthetic pretraining batch: true lengths S/2..S, ``preds``
    distinct masked positions per sequence (flat indices into [B*S]),
    random labels."""
    rng = np.random.RandomState(seed)
    S = cfg.max_seq_len
    lengths = rng.randint(S // 2, S + 1, batch)
    pos = np.stack([rng.choice(n, preds, replace=False) + i * S
                    for i, n in enumerate(lengths)])
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (batch, S, 1)),
        "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (batch, 1, 1)),
        "sent_ids": rng.randint(0, 2, (batch, S, 1)),
        "input_mask": (np.arange(S)[None, :, None] <
                       lengths[:, None, None]).astype(np.float32),
        "mask_pos": pos.reshape(-1, 1).astype(np.int32),
        "mask_label": rng.randint(0, cfg.vocab_size, (batch * preds, 1)),
        "nsp_label": rng.randint(0, 2, (batch, 1)),
    }


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def train(exe, main, scope, feed, loss, grads, steps=STEPS):
    """Losses of ``steps`` runs; the step-1 run also fetches ``grads``."""
    losses, step1 = [], None
    for i in range(steps):
        out = exe.run(main, feed=feed, fetch_list=[loss] +
                      (grads if i == 0 else []), scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if i == 0:
            step1 = [np.asarray(g) for g in out[1:]]
    return losses, step1


@pytest.fixture(scope="module")
def runs():
    jmain, jstartup, jout = build(jfluid, jbert)
    pmain, pstartup, pout = build(fluid, bert)
    cfg = pout["config"]
    feed = make_feed(cfg)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = persistables(jmain)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    params = [p.name for p in pmain.global_block().all_parameters()]
    grads = [pmain._grad_name_map[p] for p in params]
    jlosses, jgrads = train(jexe, jmain, jscope, feed, jout["loss"].name,
                            grads)
    jafter = {n: np.array(jscope.find_var(n)) for n in names}

    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    pexe = fluid.Executor(fluid.CPUPlace())
    calls = {"dq": 0, "dbias": 0}
    with pytest.MonkeyPatch.context() as mp:
        for key, name in (("dq", "dq_reference"),
                          ("dbias", "dbias_reference")):
            real = getattr(port_attn, name)

            def counted(*a, _real=real, _key=key, **kw):
                calls[_key] += 1
                return _real(*a, **kw)
            mp.setattr(port_attn, name, counted)
        plosses, pgrads = train(pexe, pmain, pscope, feed, pout["loss"],
                                grads)
    pafter = {n: pscope.find_var_numpy(n) for n in names}
    return dict(jprogs=(jmain, jstartup), pprogs=(pmain, pstartup),
                cfg=cfg, feed=feed, init=init, names=names, params=params,
                grads=grads, jlosses=jlosses, plosses=plosses,
                jgrads=jgrads, pgrads=pgrads, jafter=jafter, pafter=pafter,
                calls=calls)


def _op_types(prog):
    return [op.type for op in prog.global_block().ops]


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_programs_have_the_same_ops_and_var_shapes(runs, which):
    jprog, pprog = runs["jprogs"][which], runs["pprogs"][which]
    assert _op_types(pprog) == _op_types(jprog)
    assert {n: (v.shape, v.dtype, v.persistable)
            for n, v in pprog.global_block().vars.items()} == \
        {n: (v.shape, v.dtype, v.persistable)
         for n, v in jprog.global_block().vars.items()}
    if which == 0:
        ops = _op_types(pprog)
        n_params = len(runs["params"])
        assert ops.count("adam") == n_params
        assert ops.count("scale") == 2 * n_params + 1
        assert ops.count("fused_attention_grad") == 2
        assert sum(t.endswith("_grad") for t in ops) > 70


def test_every_persistable_is_carried_across(runs):
    """Parameters, both moments, both beta powers and the learning rate:
    the port's program reads exactly the JAX scope's persistables."""
    pmain = runs["pprogs"][0]
    assert persistables(pmain) == runs["names"]
    kinds = {"moment1", "moment2", "beta1_pow_acc", "beta2_pow_acc",
             "learning_rate"}
    assert all(any(k in n for n in runs["names"]) for k in kinds)
    for n in runs["names"]:
        assert runs["init"][n].shape == runs["pafter"][n].shape, n


def test_per_step_losses_match(runs):
    assert len(runs["plosses"]) == STEPS
    assert np.isfinite(runs["plosses"]).all()
    np.testing.assert_allclose(runs["plosses"], runs["jlosses"], rtol=1e-4)
    assert runs["plosses"][-1] < runs["plosses"][0]


def test_step1_parameter_gradients_match(runs):
    assert len(runs["pgrads"]) == len(runs["params"]) > 30
    for name, j, p in zip(runs["grads"], runs["jgrads"], runs["pgrads"]):
        assert p.shape == j.shape, name
        bound = 1e-3 * np.abs(j).max() + 1e-9
        err = np.abs(p - j).max()
        assert err <= bound, (name, err, bound)


def test_parameters_after_three_steps_match(runs):
    for n in runs["names"]:
        np.testing.assert_allclose(runs["pafter"][n], runs["jafter"][n],
                                   atol=1e-5, rtol=0, err_msg=n)


def test_fused_attention_trained_through_the_flash_backward(runs):
    """Each step ran the dQ pass once per layer (here its plain version)
    and never the dBias pass: BERT's mask needs no gradient."""
    assert runs["calls"]["dq"] == STEPS * runs["cfg"].num_layers
    assert runs["calls"]["dbias"] == 0


def test_composition_path_trains_like_the_fused_path(runs):
    """use_fused_attention=False (matmul/softmax/matmul) from the same
    persistables: the same losses and parameters, to rounding."""
    main, _, out = build(fluid, bert, use_fused_attention=False)
    assert "fused_attention" not in _op_types(main)
    assert persistables(main) == runs["names"]
    scope = fluid.Scope()
    fluid.load_numpy_params(scope, runs["init"], fluid.CPUPlace())
    losses, _ = train(fluid.Executor(fluid.CPUPlace()), main, scope,
                      runs["feed"], out["loss"], [])
    np.testing.assert_allclose(losses, runs["plosses"], rtol=1e-5)
    for n in runs["names"]:
        np.testing.assert_allclose(scope.find_var_numpy(n),
                                   runs["pafter"][n], atol=1e-5, rtol=0,
                                   err_msg=n)


def test_default_config_with_attention_dropout_trains():
    """BERT's default dropout (hidden 0.1, attention 0.1) at tiny size:
    the attention-dropout composition route and train-mode dropout run on
    the tape; the loss is finite and falls over a few steps."""
    main, startup, out = build(fluid, bert, hidden_dropout=0.1,
                               attn_dropout=0.1)
    main.random_seed = startup.random_seed = 7
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = make_feed(out["config"], seed=3)
    before = port_attn.flash_attention.launches
    losses = [float(exe.run(main, feed=feed, fetch_list=[out["loss"]],
                            scope=scope)[0][0]) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert port_attn.flash_attention.launches == before
