"""Transformer NMT training in the port (paddle_tpu_torch) against
paddle_tpu on the CPU: the same tiny program (``tiny_config`` with
dropout off: 2 + 2 layers, width 64, 4 heads, ffn 128, S=16, vocabularies
of 256; ``build_train(cfg, lr=2.0, warmup_steps=4)``: label smoothing,
loss masked by the target mask, Adam on ``noam_decay``) built in both
packages, JAX's startup persistables (parameters, Adam moments, beta
powers, the step counter ``@LR_DECAY_COUNTER@``) carried into the port's
scope with ``load_numpy_params``, then three Adam steps on one numpy
batch of 4 pairs with ragged source and target lengths.  JAX runs its
flash attention in Pallas interpret mode; the port runs
``FlashAttentionFunction`` with the plain versions of its kernels, or
the matmul/softmax composition with ``use_fused_attention=False``.
Parametrised over ``use_fused_attention`` and ``label_smooth_eps`` (0.1,
and 0: hard labels, no ``one_hot``).

Tolerances, float32 throughout:
- the fetched learning rate of each step ``rtol 1e-6``;
- per-step losses ``rtol 1e-4``;
- step-1 parameter gradients ``|Δ| <= 1e-3·max|g| + 1e-9`` (the floor
  for the key projections' biases, whose gradient is rounding noise, as
  in tests/test_torch_bert_training.py);
- parameters after step 3, three steps chained: Adam's moments, beta
  powers and the step counter within 1e-5; each parameter's update,
  and the whole update, within 1e-3 of its size in relative L2; every
  parameter entry within the larger of 1e-5 and twice how far the
  reference's own two routes (fused, and the composition) lie apart
  after the same steps (2.5e-3).
  At this learning rate (0.03-0.09 a step) Adam turns each entry's
  rounding into a step of up to the learning rate times its relative
  error, and errors carry from step to step: 38-45 of the 441
  persistables end more than 1e-5 from the reference, and paddle_tpu's
  two routes leave 33-37 more than 1e-5 apart (``python
  tests/test_torch_transformer_training.py`` prints these readings).
  The key projections' biases, whose gradient is rounding noise (zero
  in exact arithmetic), are found by their step-1 gradient and held by
  the entry bound alone;
- each step again from the reference's state before it: the port's
  step equals Adam's update of its own gradient within 1e-5, and every
  parameter entry lies within 1e-5 plus how far Adam moves that entry
  when its gradient moves by a few float32 roundings;
- the main and startup programs' op-type sequences and variable shapes
  equal to the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.ops import attention_ops as port_attn
from paddle_tpu_torch.models import transformer
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

B, STEPS, LR, WARMUP = 4, 3, 2.0, 4
COUNTER = "@LR_DECAY_COUNTER@"
CASES = [(True, 0.1), (True, 0.0), (False, 0.1), (False, 0.0)]
# a gradient entry at most one float32 rounding of the step's largest
# entry is rounding noise
NOISE = 2.0 ** -23
# what a step's gradient entry may differ by: four float32 roundings of
# its tensor's largest entry and a quarter of one of the step's largest
GRAD_ROUNDING, STEP_ROUNDING = 2.0 ** -21, 2.0 ** -25


def build(pkg, mod, cfg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_train(cfg, lr=LR, warmup_steps=WARMUP)
    return main, startup, out


def make_feed(cfg, batch=B, seed=0):
    """Random token ids and labels; source and target keep-masks with
    true lengths S/2..S drawn per pair."""
    rng = np.random.RandomState(seed)
    S = cfg.max_len

    def mask():
        n = rng.randint(S // 2, S + 1, batch)
        return (np.arange(S)[None, :, None] < n[:, None, None]).astype(
            np.float32)
    return {
        "src_ids": rng.randint(0, cfg.src_vocab_size, (batch, S, 1)),
        "src_mask": mask(),
        "trg_ids": rng.randint(0, cfg.trg_vocab_size, (batch, S, 1)),
        "trg_mask": mask(),
        "label": rng.randint(0, cfg.trg_vocab_size, (batch, S, 1)),
    }


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def train(exe, main, scope, feed, loss, lr, grads, read, steps=STEPS):
    """(losses, learning rates, each step's gradients, the persistables
    after each step) of ``steps`` runs; ``read(scope)`` returns the
    persistables."""
    losses, lrs, step_grads, states = [], [], [], []
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=[loss, lr] + grads,
                      scope=scope)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        lrs.append(float(np.asarray(out[1]).reshape(-1)[0]))
        step_grads.append([np.asarray(g) for g in out[2:]])
        states.append(read(scope))
    return losses, lrs, step_grads, states


_REFERENCE = {}


def reference(eps):
    """paddle_tpu's three steps on both attention routes (fused, the
    composition) from one set of startup persistables, that of the fused
    program, for label smoothing ``eps``; computed once per ``eps``."""
    if eps in _REFERENCE:
        return _REFERENCE[eps]
    out = {}
    for fused in (True, False):
        main, startup, handles = build(jfluid, jtransformer,
                                       jtransformer.tiny_config(
                                           dropout=0.0, label_smooth_eps=eps,
                                           use_fused_attention=fused))
        names = persistables(main)
        if fused:
            scope = jfluid.Scope()
            jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
            init = {n: np.array(scope.find_var(n)) for n in names}
        scope = jfluid.Scope()
        for n in names:
            scope.set_var(n, jnp.asarray(init[n]))
        params = [p.name for p in main.global_block().all_parameters()]
        grads = [main._grad_name_map[p] for p in params]
        lr = handles["optimizer"]._global_learning_rate(main).name
        losses, lrs, g, states = train(
            jfluid.Executor(jfluid.CPUPlace()), main, scope,
            make_feed(handles["config"]), handles["loss"].name, lr, grads,
            lambda sc, _n=names: {n: np.array(sc.find_var(n)) for n in _n})
        out[fused] = dict(progs=(main, startup), names=names, lr=lr,
                          losses=losses, lrs=lrs, grads=g,
                          states=[init] + states, after=states[-1])
    out["init"] = init
    # how far the reference's own two routes lie apart after three steps
    out["spread"] = max(float(np.abs(out[True]["after"][n] -
                                     out[False]["after"][n]).max())
                        for n in out[True]["names"])
    _REFERENCE[eps] = out
    return out


@pytest.fixture(scope="module", params=CASES,
                ids=["fused-eps0.1", "fused-eps0", "composition-eps0.1",
                     "composition-eps0"])
def runs(request):
    return compare(*request.param)


def compare(fused, eps):
    """The port's three chained steps and the three steps again from the
    reference's states, beside paddle_tpu's, for one case."""
    ref = reference(eps)
    jref = ref[fused]
    pmain, pstartup, pout = build(fluid, transformer, transformer.tiny_config(
        dropout=0.0, use_fused_attention=fused, label_smooth_eps=eps))
    cfg = pout["config"]
    names, init = jref["names"], ref["init"]
    params = [p.name for p in pmain.global_block().all_parameters()]
    grads = [pmain._grad_name_map[p] for p in params]
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
    carried = {n: pscope.find_var_numpy(n) for n in names}
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
        plr = pout["optimizer"]._global_learning_rate(pmain)
        read = lambda sc: {n: sc.find_var_numpy(n) for n in names}
        plosses, plrs, pgrads, pstates = train(
            pexe, pmain, pscope, make_feed(cfg), pout["loss"], plr, grads,
            read)
    # each step again, from the reference's state before it
    forced = []
    for t in range(STEPS):
        scope = fluid.Scope()
        fluid.load_numpy_params(scope, jref["states"][t], fluid.CPUPlace())
        _, _, g, after = train(pexe, pmain, scope, make_feed(cfg),
                               pout["loss"], plr, grads, read, steps=1)
        forced.append(dict(grads=g[0], after=after[0]))
    pafter = pstates[-1]
    return dict(jprogs=jref["progs"], pprogs=(pmain, pstartup),
                cfg=cfg, fused=fused, eps=eps, names=names, init=init,
                params=params, grads=grads, jlr=jref["lr"], plr=plr.name,
                jlosses=jref["losses"], plosses=plosses, jlrs=jref["lrs"],
                plrs=plrs, jgrads=jref["grads"], pgrads=pgrads,
                jstates=jref["states"], forced=forced,
                jafter=jref["after"], pafter=pafter, calls=calls,
                spread=ref["spread"], carried=carried)


def _op_types(prog):
    return [op.type for op in prog.global_block().ops]


def _var_sig(prog):
    return {n: (v.shape, v.dtype, v.persistable)
            for n, v in prog.global_block().vars.items()}


def test_programs_have_the_reference_ops_and_var_shapes(runs):
    """The op-type sequences and every variable's declared shape, dtype
    and persistability, main and startup, are the reference's (so
    ``loss * w`` and ``reduce_sum(loss) / reduce_sum(w)`` declare its
    shapes)."""
    for jprog, pprog in zip(runs["jprogs"], runs["pprogs"]):
        assert _op_types(pprog) == _op_types(jprog)
        assert _var_sig(pprog) == _var_sig(jprog)
    ops = _op_types(runs["pprogs"][0])
    assert ops.count("adam") == len(runs["params"])
    assert ops.count("increment") == 1
    assert ops.count("one_hot") == (1 if runs["eps"] else 0)
    n_attn = 3 * runs["cfg"].num_layers
    assert ops.count("fused_attention") == (n_attn if runs["fused"] else 0)
    assert runs["plr"] == runs["jlr"]


def test_every_persistable_is_carried_across(runs):
    """Parameters (every fc weight drawn by truncated_gaussian_random),
    Adam's moments and beta powers and the step counter: the port's
    program reads exactly the JAX scope's persistables,
    ``load_numpy_params`` carries each bit for bit, and the counter is at
    3 after three steps in both."""
    assert persistables(runs["pprogs"][0]) == runs["names"]
    for n in runs["names"]:
        assert runs["carried"][n].dtype == runs["init"][n].dtype, n
        np.testing.assert_array_equal(runs["carried"][n], runs["init"][n])
    L = runs["cfg"].num_layers
    assert _op_types(runs["pprogs"][1]).count(
        "truncated_gaussian_random") == 16 * L + 1
    assert COUNTER in runs["names"]
    assert not any("learning_rate" in n for n in runs["names"])
    np.testing.assert_array_equal(runs["init"][COUNTER], [0.0])
    np.testing.assert_array_equal(runs["pafter"][COUNTER], [STEPS])
    np.testing.assert_array_equal(runs["jafter"][COUNTER], [STEPS])


def test_learning_rate_of_each_step_matches(runs):
    t = np.arange(1, STEPS + 1, dtype=np.float64)
    want = LR * runs["cfg"].hidden_size ** -0.5 * \
        np.minimum(t ** -0.5, t * WARMUP ** -1.5)
    np.testing.assert_allclose(runs["plrs"], runs["jlrs"], rtol=1e-6)
    np.testing.assert_allclose(runs["plrs"], want, rtol=1e-6)


def test_per_step_losses_match(runs):
    assert np.isfinite(runs["plosses"]).all()
    np.testing.assert_allclose(runs["plosses"], runs["jlosses"], rtol=1e-4)


def test_step1_parameter_gradients_match(runs):
    assert len(runs["pgrads"][0]) == len(runs["params"]) > 60
    for name, j, p in zip(runs["grads"], runs["jgrads"][0],
                          runs["pgrads"][0]):
        assert p.shape == j.shape, name
        bound = 1e-3 * np.abs(j).max() + 1e-9
        err = np.abs(p - j).max()
        assert err <= bound, (name, err, bound)


def _adam_attrs(prog):
    op = next(op for op in prog.global_block().ops if op.type == "adam")
    return {k: float(np.float32(op.attr(k)))
            for k in ("beta1", "beta2", "epsilon")}


def _adam(state, name, g, lr, beta1, beta2, epsilon):
    """Adam's update of parameter ``name`` from the persistables
    ``state`` with gradient ``g`` at learning rate ``lr``, in float64:
    the reference's rule (``lr·sqrt(1−β2^t)/(1−β1^t)·m1/(sqrt(m2)+eps)``)."""
    g = np.asarray(g, np.float64)
    m1 = beta1 * state[name + "_moment1_0"] + (1 - beta1) * g
    m2 = beta2 * state[name + "_moment2_0"] + (1 - beta2) * g * g
    b1p = float(state[name + "_beta1_pow_acc_0"].reshape(-1)[0])
    b2p = float(state[name + "_beta2_pow_acc_0"].reshape(-1)[0])
    return state[name] - lr * np.sqrt(1 - b2p) / (1 - b1p) * m1 / (
        np.sqrt(m2) + epsilon)


def test_parameters_after_three_steps_match(runs):
    """Three chained steps.  Every persistable that is not a parameter
    (Adam's moments and beta powers, the step counter) within 1e-5; each
    parameter's update, and the whole update, within 1e-3 of its own
    size in relative L2; every parameter entry within the larger of 1e-5
    and twice how far the reference's own two attention routes lie apart
    after the same three steps.  The tensors whose step-1 gradient is at rounding level are
    exactly the key projections' biases, one per attention op (their
    gradient is zero in exact arithmetic); their updates are rounding
    noise, so only the entry bound holds them."""
    top = max(np.abs(g).max() for g in runs["jgrads"][0])
    noise = {n for n, g in zip(runs["params"], runs["jgrads"][0])
             if np.abs(g).max() <= NOISE * top}
    assert len(noise) == 3 * runs["cfg"].num_layers
    assert all(n.endswith(".b_0") for n in noise)
    bound = max(1e-5, 2 * runs["spread"])
    assert bound < 1e-2
    for n in runs["names"]:
        got, want = runs["pafter"][n], runs["jafter"][n]
        if n not in runs["params"]:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                       err_msg=n)
            continue
        np.testing.assert_allclose(got, want, atol=bound, rtol=0, err_msg=n)
        if n not in noise:
            update = want.astype(np.float64) - runs["init"][n]
            rel = np.linalg.norm(got - want) / np.linalg.norm(update)
            assert rel <= 1e-3, (n, rel)
    num = den = 0.0
    for n in runs["params"]:
        want = runs["jafter"][n].astype(np.float64)
        num += float(((runs["pafter"][n] - want) ** 2).sum())
        den += float(((want - runs["init"][n]) ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def test_each_step_from_the_reference_state_matches(runs):
    """Each of the three steps run again in the port from the
    reference's persistables before it, so that no error carries over
    from an earlier step.  The port's step is Adam's update of its own
    fetched gradient within 1e-5.  Each parameter entry lies within 1e-5
    of the reference's step plus how far Adam's update of that entry
    moves when its gradient moves by the rounding a float32 gradient
    carries (GRAD_ROUNDING of its tensor's largest entry and
    STEP_ROUNDING of the step's): Adam divides each entry's first moment
    by its own root mean square, so an entry that is small beside the
    terms summed into it, or whose moment nearly cancels, turns that
    rounding into a step of up to the learning rate."""
    adam = _adam_attrs(runs["pprogs"][0])
    for t, forced in enumerate(runs["forced"]):
        before, want = runs["jstates"][t], runs["jstates"][t + 1]
        jgrads = [g.astype(np.float64) for g in runs["jgrads"][t]]
        top = max(np.abs(g).max() for g in jgrads)
        lr = runs["jlrs"][t]
        for n, g, pg in zip(runs["params"], jgrads, forced["grads"]):
            got = forced["after"][n]
            np.testing.assert_allclose(got, _adam(before, n, pg, lr, **adam),
                                       atol=1e-5, rtol=0, err_msg=n)
            base = _adam(before, n, g, lr, **adam)
            d = GRAD_ROUNDING * np.abs(g).max() + STEP_ROUNDING * top
            bound = 1e-5 + np.maximum(
                np.abs(_adam(before, n, g + d, lr, **adam) - base),
                np.abs(_adam(before, n, g - d, lr, **adam) - base))
            err = np.abs(got - want[n])
            assert (err <= bound).all(), (t, n, float(err.max()))


def test_attention_trained_through_its_route(runs):
    """The fused route ran the dQ pass (here its plain version) once per
    attention op and step, and never the dBias pass: the pad bias and the
    causal mask need no gradient.  The composition route ran neither."""
    n = 3 * runs["cfg"].num_layers * STEPS if runs["fused"] else 0
    assert runs["calls"] == {"dq": n, "dbias": 0}


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_base_config_builds_the_reference_program(which):
    """bench_nmt's program (base_config: 6 + 6 layers, width 512, 8
    heads, S=256, vocabularies of 30,000) has the reference's op-type
    sequence: 1,763 ops in main, 1,281 in startup, 97 of them the fc
    weights' truncated_gaussian_random."""
    progs = [build(pkg, mod, mod.base_config())[which]
             for pkg, mod in ((jfluid, jtransformer),
                              (fluid, transformer))]
    types = [_op_types(p) for p in progs]
    assert types[1] == types[0]
    assert len(types[1]) == (1763, 1281)[which]
    if which == 1:      # the 97 fc weights, 6 + 10 a layer and the output
        assert types[1].count("truncated_gaussian_random") == 97


def readings():
    """Prints, for each case, how far the port's parameters lie from the
    reference's: after three chained steps (the persistables more than
    1e-5 away, the largest entry and the largest relative L2 of a
    parameter's update outside the key projections' biases), how far the
    reference's own two routes lie apart, and each step again from the
    reference's state (the parameter entries more than 1e-5 away, the
    share whose bound exceeds 2e-5, the largest error over its bound)."""
    adam = None
    for fused, eps in CASES:
        r = compare(fused, eps)
        ref = reference(eps)
        adam = adam or _adam_attrs(r["pprogs"][0])
        far = {n: float(np.abs(r["pafter"][n] - r["jafter"][n]).max())
               for n in r["names"]}
        apart = [n for n in r["names"] if np.abs(
            ref[True]["after"][n] - ref[False]["after"][n]).max() > 1e-5]
        top = max(np.abs(g).max() for g in r["jgrads"][0])
        rel = max((np.linalg.norm(r["pafter"][n] - r["jafter"][n]) /
                   np.linalg.norm(r["jafter"][n] - r["init"][n]), n)
                  for n, g in zip(r["params"], r["jgrads"][0])
                  if np.abs(g).max() > NOISE * top)
        over, loose, total, ratio = 0, 0, 0, 0.0
        for t, forced in enumerate(r["forced"]):
            before, want = r["jstates"][t], r["jstates"][t + 1]
            grads = [g.astype(np.float64) for g in r["jgrads"][t]]
            gtop = max(np.abs(g).max() for g in grads)
            for n, g in zip(r["params"], grads):
                base = _adam(before, n, g, r["jlrs"][t], **adam)
                d = GRAD_ROUNDING * np.abs(g).max() + STEP_ROUNDING * gtop
                bound = 1e-5 + np.maximum(*(np.abs(_adam(
                    before, n, g + x, r["jlrs"][t], **adam) - base)
                    for x in (d, -d)))
                err = np.abs(forced["after"][n] - want[n])
                over += int((err > 1e-5).sum())
                loose += int((bound > 2e-5).sum())
                total += err.size
                ratio = max(ratio, float((err / bound).max()))
        worst = sorted(far.items(), key=lambda kv: -kv[1])[:4]
        print("fused=%s eps=%g: chained: %d of %d persistables > 1e-5, "
              "largest %s; largest update rel L2 %.2e (%s); reference "
              "routes: %d > 1e-5, largest %.2e; from the reference's "
              "states: %d of %d parameter entries > 1e-5, %.1f%% with a "
              "bound > 2e-5, largest error/bound %.2f"
              % (fused, eps, sum(v > 1e-5 for v in far.values()),
                 len(far), ", ".join("%s %.2e" % kv for kv in worst),
                 rel[0], rel[1], len(apart), ref["spread"], over, total,
                 100.0 * loose / total, ratio))


if __name__ == "__main__":
    # python tests/test_torch_transformer_training.py (CPU, ~90 s)
    import jax
    jax.config.update("jax_platforms", "cpu")
    readings()
