"""Pipeline parallelism in the port (``fluid.device_guard``,
``fluid.optimizer.PipelineOptimizer``, ``fluid/pipeline.py``'s GPipe
schedule with one process per stage) against paddle_tpu's pipelined runs
on its eight-device virtual CPU mesh.

One 4-process gloo pack (this file is its worker) runs every port side;
the JAX side runs in this process while the ranks run.  Each program
starts from JAX's startup persistables.  The cases of
tests/test_pipeline.py, each per step at JAX's own tolerance
(``rtol=2e-4, atol=1e-6``; the clip case 5e-4) and against the port's
unpipelined run of the same program:

- the four-stage MLP matches plain training (8 steps);
- L2 regularization and global-norm clipping land in the post phase:
  losses and every parameter after 3 steps;
- non-chain cuts are refused with JAX's message;
- parameters stored sharded: each rank holds 1/S of every shardable
  parameter and of its Momentum velocity; ``shard_params=False`` holds
  them whole, and both train alike (1e-5);

and, at two stages in the same four ranks (dp 2 x pp 2):

- a stage-boundary var that is not a float of 32 bits or fewer raises
  JAX's TypeError, and fetching anything but the loss JAX's
  NotImplementedError, on every rank;
- a bf16 boundary arrives bit-equal: with one microbatch the pipelined
  step-1 loss equals the unpipelined one bit for bit;
- a parameter read by two stages gets both stages' gradient;
- dropout: each microbatch draws its own mask, and the backward's
  recompute of a stage replays the forward's output bit for bit;
- ``run_window`` of K=4 is bit-equal to four runs, and with spans on
  each step records its five phases;
- tiny BERT in two stages (embeddings and layer 0; layer 1, the heads
  and the loss), ``mask_pos`` re-based to its microbatch, against JAX's
  pipeline fed the same and the unpipelined program fed the original
  indices.
"""

import contextlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid

from test_torch_collective_ops import pack_logs, start_pack, wait_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_tensor_parallel import (bert_feed, build, load_case,
                                        persistables, save_case)

NPROC = 4
RTOL, ATOL = 2e-4, 1e-6        # tests/test_pipeline.py
CLIP_RTOL = 5e-4               # ... its global-norm clip case
B, D, H, M, S = 16, 8, 32, 4, 4
WEIGHTS = ["w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3"]


# ---------------------------------------------------------------------------
# Programs, built the same way in both packages
# ---------------------------------------------------------------------------

def mlp(pipeline=True, weight_decay=None, clip_norm=None, momentum=False,
        shard_params=True):
    """tests/test_pipeline.py::_build: four fc stages, SGD 0.1."""
    def b(pkg):
        L = pkg.layers

        def stage(k):
            return pkg.device_guard("pp:%d" % k) if pipeline \
                else pkg.device_guard(None)

        def fc(h, size, i, act="relu"):
            return L.fc(input=h, size=size, act=act,
                        param_attr=pkg.ParamAttr(name="w%d" % i),
                        bias_attr=pkg.ParamAttr(name="b%d" % i))
        with stage(0):
            x = L.data(name="x", shape=[B, D], dtype="float32",
                       append_batch_size=False)
            h = fc(x, H, 0)
        with stage(1):
            h = fc(h, H, 1)
        with stage(2):
            h = fc(h, H, 2)
        with stage(3):
            y = L.data(name="y", shape=[B, 1], dtype="float32",
                       append_batch_size=False)
            pred = fc(h, 1, 3, act=None)
            loss = L.reduce_mean(L.square_error_cost(pred, y))
        if clip_norm:
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(clip_norm),
                program=pkg.default_main_program())
        reg = pkg.regularizer.L2Decay(weight_decay) if weight_decay else None
        inner = pkg.optimizer.MomentumOptimizer(0.1, 0.9,
                                                regularization=reg) \
            if momentum else \
            pkg.optimizer.SGDOptimizer(learning_rate=0.1, regularization=reg)
        if pipeline:
            pkg.optimizer.PipelineOptimizer(
                inner, num_microbatches=M,
                shard_params=shard_params).minimize(loss)
        else:
            inner.minimize(loss)
        return loss
    return b


B2 = 8                           # two-stage programs: rows, microbatches
M2 = 2


def two_stage(kind, pipeline=True, micro=M2, rows=B2):
    """Two-stage programs: ``tied`` (stage 0's and stage 1's fc share
    their weight), ``bf16`` (a bf16 var crosses the cut), ``dropout``
    (dropout 0.5 before the cut), ``int`` (an int32 var crosses) and
    ``mlp`` (the plain two-stage MLP)."""
    def b(pkg):
        L = pkg.layers

        def stage(k):
            return pkg.device_guard("pp:%d" % k) if pipeline \
                else contextlib.nullcontext()
        tied = pkg.ParamAttr(name="tied_w")
        with stage(0):
            x = L.data(name="x", shape=[rows, H], dtype="float32",
                       append_batch_size=False)
            h = L.fc(x, size=H, act="tanh",
                     param_attr=tied if kind == "tied" else None)
            if kind == "bf16":
                h = L.cast(h, "bfloat16")
            elif kind == "int":
                h = L.cast(L.scale(h, scale=100.0), "int32")
            elif kind == "dropout":
                h = L.dropout(h, 0.5,
                              dropout_implementation="upscale_in_train")
        with stage(1):
            y = L.data(name="y", shape=[rows, 1], dtype="float32",
                       append_batch_size=False)
            if kind in ("bf16", "int"):
                h = L.cast(h, "float32")
            h = L.fc(h, size=H, act="tanh",
                     param_attr=tied if kind == "tied" else None)
            pred = L.fc(h, size=1)
            loss = L.reduce_mean(L.square_error_cost(pred, y))
        inner = pkg.optimizer.SGDOptimizer(0.1)
        if pipeline:
            pkg.optimizer.PipelineOptimizer(
                inner, num_microbatches=micro).minimize(loss)
        else:
            inner.minimize(loss)
        return loss
    return b


def bert_config():
    from paddle_tpu_torch.models import bert
    return bert.tiny_config(attn_dropout=0.0, hidden_dropout=0.0)


BERT_ROWS, BERT_PRED = 2, 4       # rows that dp 2 x M 2 does not divide


def bert_two_stages(pipeline=True, lr=1e-3):
    """Tiny BERT pretraining from ``models/bert.py``'s pieces: stage 0
    the embeddings, the attention bias and the first half of the layers;
    stage 1 the other half, the MLM and NSP heads and the loss.  The
    parameters are created in ``build_pretrain``'s order, so they carry
    its names; the unpipelined program is ``build_pretrain`` itself."""
    def b(pkg):
        from importlib import import_module
        base = "paddle_tpu" if pkg.__name__.startswith("paddle_tpu.") \
            else "paddle_tpu_torch"
        bert = import_module(base + ".models.bert")
        cfg = bert.tiny_config(attn_dropout=0.0, hidden_dropout=0.0)
        opt = pkg.optimizer.AdamOptimizer(learning_rate=lr)
        if not pipeline:
            return bert.build_pretrain(cfg, max_pred_per_seq=BERT_PRED,
                                       optimizer=opt)["loss"]
        return build_bert_two_stages(pkg, bert, cfg, M2, opt)
    return b


def build_bert_two_stages(pkg, bert, cfg, micro, opt):
    L = pkg.layers
    Sq, Hd = cfg.max_seq_len, cfg.hidden_size
    half = cfg.num_layers // 2
    with pkg.device_guard("pp:0"):
        src_ids = L.data(name="src_ids", shape=[Sq, 1], dtype="int64")
        pos_ids = L.data(name="pos_ids", shape=[Sq, 1], dtype="int64")
        sent_ids = L.data(name="sent_ids", shape=[Sq, 1], dtype="int64")
        input_mask = L.data(name="input_mask", shape=[Sq, 1],
                            dtype="float32")
        # bert_encoder's embeddings and attention bias, then its layers
        emb = L.embedding(src_ids, size=[cfg.vocab_size, Hd],
                          param_attr=pkg.ParamAttr(
                              name="word_embedding",
                              initializer=pkg.initializer.TruncatedNormal(
                                  scale=0.02)))
        pos = L.embedding(pos_ids, size=[cfg.max_position, Hd],
                          param_attr=bert._param("pos"))
        sent = L.embedding(sent_ids, size=[cfg.type_vocab_size, Hd],
                           param_attr=bert._param("sent"))
        x = L.layer_norm(emb + pos + sent, begin_norm_axis=2)
        mask2d = L.matmul(input_mask, input_mask, transpose_y=True)
        attn_bias = L.unsqueeze(L.scale(mask2d, scale=1e4, bias=-1.0,
                                        bias_after_scale=False), [1])
        attn_bias.stop_gradient = True
        for _ in range(half):
            x = bert.encoder_layer(x, attn_bias, cfg)
    with pkg.device_guard("pp:1"):
        mask_pos = L.data(name="mask_pos", shape=[1], dtype="int32")
        mask_label = L.data(name="mask_label", shape=[1], dtype="int64")
        nsp_label = L.data(name="nsp_label", shape=[1], dtype="int64")
        for _ in range(half, cfg.num_layers):
            x = bert.encoder_layer(x, attn_bias, cfg)
        mlm_logits, nsp_logits = bert.pretrain_heads(x, mask_pos, cfg)
        loss = L.mean(L.softmax_with_cross_entropy(mlm_logits, mask_label)) \
            + L.mean(L.softmax_with_cross_entropy(nsp_logits, nsp_label))
    pkg.optimizer.PipelineOptimizer(opt, num_microbatches=micro).minimize(
        loss)
    return loss


def rebase_mask_pos(feed, micro, seq_len):
    """``mask_pos`` of a pretraining batch re-based to its microbatch:
    index - k·(B/M)·S for the rows of microbatch k (the pipeline cuts
    every feed into M microbatches; the indices address the whole
    ``[B·S, H]`` output)."""
    rows = len(feed["src_ids"]) // micro
    per = len(feed["mask_pos"]) // micro
    out = dict(feed)
    mp = feed["mask_pos"].copy()
    for k in range(micro):
        mp[k * per:(k + 1) * per] -= k * rows * seq_len
    out["mask_pos"] = mp
    return out


# ---------------------------------------------------------------------------
# Feeds and cases
# ---------------------------------------------------------------------------

def mlp_feeds(steps=8):
    rng = np.random.RandomState(0)
    x = rng.randn(B, D).astype(np.float32)
    y = (x.sum(1, keepdims=True) * 0.2).astype(np.float32)
    return [{"x": x, "y": y}] * steps


def two_feeds(steps=4, rows=B2):
    rng = np.random.RandomState(4)
    return [{"x": rng.randn(rows, H).astype(np.float32),
             "y": rng.randn(rows, 1).astype(np.float32)}
            for _ in range(steps)]


def bert_feeds(steps=3):
    cfg = bert_config()
    rng = np.random.RandomState(2)
    return [bert_feed(rng, cfg, BERT_ROWS, BERT_PRED) for _ in range(steps)]


# name: (pipelined make, unpipelined make, feeds, rtol)
CASES = {
    "plain": (mlp(), mlp(False), mlp_feeds, RTOL),
    "regularization": (mlp(weight_decay=0.5), mlp(False, weight_decay=0.5),
                       lambda: mlp_feeds(3), RTOL),
    "global_norm_clip": (mlp(clip_norm=0.05), mlp(False, clip_norm=0.05),
                         lambda: mlp_feeds(3), CLIP_RTOL),
    "momentum": (mlp(momentum=True), mlp(False, momentum=True),
                 lambda: mlp_feeds(3), RTOL),
    "tied": (two_stage("tied"), two_stage("tied", False), two_feeds, RTOL),
    "bf16": (two_stage("bf16", micro=1, rows=3),
             two_stage("bf16", False, rows=3),
             lambda: two_feeds(2, rows=3), RTOL),
    "bert": (bert_two_stages(), bert_two_stages(False), bert_feeds, RTOL),
}
PORT_ONLY = {   # name: (make, feeds)
    "replicated": (mlp(shard_params=False), lambda: mlp_feeds(4)),
    "dropout": (two_stage("dropout"), lambda: two_feeds(2)),
    "window": (two_stage("mlp"), two_feeds),
}
REFUSED = {     # name: (make, fetch the loss?, error type, JAX's message)
    "int_boundary": (two_stage("int"), True, "TypeError",
                     "only <=32-bit float activations may cross a "
                     "pipeline cut"),
    "non_loss_fetch": (two_stage("mlp"), False, "NotImplementedError",
                       "pipeline runs fetch only the loss"),
}


def publish_case(out_dir, name, case):
    """``save_case``, then the marker the ranks wait for (the pack starts
    before the JAX side has prepared every case)."""
    save_case(out_dir, name, case)
    (Path(out_dir) / ("ready_%s" % name)).touch()


def wait_case(out_dir, name, timeout=600):
    """``load_case`` once :func:`publish_case` has written the case."""
    import time
    marker = Path(out_dir) / ("ready_%s" % name)
    t0 = time.monotonic()
    while not marker.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("case %r was not published" % name)
        time.sleep(0.05)
    return load_case(out_dir, name)


def _pipelined_feeds(name, feeds):
    if name != "bert":
        return feeds
    cfg = bert_config()
    return [rebase_mask_pos(f, M2, cfg.max_seq_len) for f in feeds]


def jax_prepare(make):
    """JAX's program of ``make`` after its startup: (its startup
    persistables, a function running the given feeds and returning the
    losses and {name: value after the last step} of the given names)."""
    import paddle_tpu.fluid as jfluid
    main, startup, loss = build(jfluid, make)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.find_var(n)) for n in persistables(main)
            if scope.find_var(n) is not None}

    def run(feeds, names=()):
        losses = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for f in feeds]
        return losses, {n: np.asarray(scope.find_var(n)) for n in names}
    return init, run


def port_plain(make, feeds, init, names=()):
    """The port's unpipelined run in this process."""
    main, startup, loss = build(fluid, make)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0]) for f in feeds]
    return losses, {n: scope.find_var_numpy(n) for n in names}


# ---------------------------------------------------------------------------
# The pack
# ---------------------------------------------------------------------------

def _load_run(out_dir, name, make, fetch=True, window=None):
    """This rank's run of a saved case: (losses, scope, main, exe)."""
    init, feeds = wait_case(out_dir, name)
    main, startup, loss = build(fluid, make)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.load_numpy_params(scope, init, fluid.CPUPlace())
    if window:
        stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
        out = exe.run_window(main, feed=stacked, fetch_list=[loss],
                             scope=scope, steps_per_run=len(feeds))[0]
        return out.reshape(-1).tolist(), scope, main, exe
    target = loss if fetch else main.global_block().ops[0].output("Out")[0]
    losses = [float(exe.run(main, feed=f, fetch_list=[target],
                            scope=scope)[0].reshape(-1)[0]) for f in feeds]
    return losses, scope, main, exe


def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist
    from paddle_tpu_torch.fluid import pipeline
    from paddle_tpu_torch.parallel import tensor_parallel as ptp
    torch.set_num_threads(1)
    rank, n = dist.init(place=fluid.CPUPlace())
    res = {"rank": rank, "world": n, "losses": {}, "weights": {},
           "shapes": {}, "errors": {}, "comm": {}}

    def shapes(scope, main):
        return {nm: list(scope.find_var(nm).shape)
                for nm in persistables(main)
                if scope.find_var(nm) is not None}

    for name, (make, _plain, _f, _t) in CASES.items():
        ptp.reset_comm()
        losses, scope, main, exe = _load_run(out_dir, name, make)
        res["losses"][name] = losses
        res["shapes"][name] = shapes(scope, main)
        res["weights"][name] = {w: scope.find_var_numpy(w).tolist()
                                for w in WEIGHTS if scope.has_var(w)}
        res["comm"][name] = {"%s@%s" % k: list(v)
                             for k, v in ptp.comm.items()}
        if name == "bf16":
            plan = next(p for p in exe._plans.values()
                        if p.pipeline is not None)
            res["bf16_in"] = [str(dt) for _s, dt in
                              plan.pipeline.in_specs or ()]
            res["bf16_links"] = dict(main._opt_state_of)
        if name == "momentum":
            res["links"] = dict(main._opt_state_of)
    make, _feeds = PORT_ONLY["replicated"]
    res["losses"]["replicated"], scope, main, _e = _load_run(
        out_dir, "replicated", make)
    res["shapes"]["replicated"] = shapes(scope, main)

    # dropout: record the stage's boundary output each time it runs
    seen = []
    orig = pipeline.PipelineStep._run_stage

    def recording(self, env, st):
        orig(self, env, st)
        if self.outs:
            seen.append((torch.is_grad_enabled(), st.stream,
                         env[self.outs[0]].detach().clone()))
    pipeline.PipelineStep._run_stage = recording
    try:
        make, _feeds = PORT_ONLY["dropout"]
        res["losses"]["dropout"] = _load_run(out_dir, "dropout", make)[0]
    finally:
        pipeline.PipelineStep._run_stage = orig
    fwd = [(k, t) for g, k, t in seen if not g]
    rec = [(k, t) for g, k, t in seen if g]
    res["dropout_recompute_equal"] = [
        bool(torch.equal(a, b)) and ka == kb
        for (ka, a), (kb, b) in zip(fwd, rec)]
    res["dropout_mask_differs"] = [
        bool(((fwd[i][1] == 0) != (fwd[i + 1][1] == 0)).any())
        for i in range(0, len(fwd) - 1, 2)]
    res["dropout_zero_share"] = [float((t == 0).float().mean())
                                 for _k, t in fwd]

    make, _feeds = PORT_ONLY["window"]
    from paddle_tpu_torch.fluid import telemetry
    n0 = telemetry.step_events_recorded()
    telemetry.enable_spans(True)
    try:
        res["losses"]["window_runs"] = _load_run(out_dir, "window", make)[0]
    finally:
        telemetry.enable_spans(False)
    ev = telemetry.step_events()[-(telemetry.step_events_recorded() - n0):]
    res["spans"] = sorted({(e["span"], e["stage"]) for e in ev
                           if e.get("span", "").startswith("pipeline_")})
    res["losses"]["window"] = _load_run(out_dir, "window", make,
                                        window=True)[0]

    for name, (make, fetch, _kind, _msg) in REFUSED.items():
        try:
            _load_run(out_dir, name, make, fetch=fetch)
            res["errors"][name] = None
        except (TypeError, NotImplementedError) as e:
            res["errors"][name] = [type(e).__name__, str(e)]
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("pipeline_pack")
    proc = start_pack(Path(__file__), out_dir, nproc=NPROC)
    try:
        # every case published first, so the ranks never wait for JAX's
        # runs; then JAX's runs while the ranks run
        prepared = {}
        for name, (make, _plain, feeds_fn, _t) in CASES.items():
            init, run = jax_prepare(make)
            publish_case(out_dir, name,
                         (init, _pipelined_feeds(name, feeds_fn())))
            prepared[name] = (init, run)
        for name, (make, feeds_fn) in PORT_ONLY.items():
            init = prepared["plain"][0] if name == "replicated" else \
                jax_prepare(make)[0]
            publish_case(out_dir, name, (init, feeds_fn()))
        for name, (make, _fetch, _k, _m) in REFUSED.items():
            publish_case(out_dir, name, (jax_prepare(make)[0],
                                         two_feeds(1)))
        jax_runs = {}
        for name, (init, run) in prepared.items():
            feeds_fn = CASES[name][2]
            losses, weights = run(
                _pipelined_feeds(name, feeds_fn()),
                WEIGHTS if name in ("regularization", "global_norm_clip")
                else ())
            jax_runs[name] = (losses, weights, init, feeds_fn())
        plain = {}
        for name, (_make, plain_make, _f, _t) in CASES.items():
            losses, weights, init, feeds = jax_runs[name]
            plain[name] = port_plain(plain_make, feeds, init, weights)
    finally:
        done = wait_pack(proc, timeout=600)
    assert done.returncode == 0, \
        done.stderr[-3000:] + pack_logs(out_dir, NPROC)
    ranks = [json.loads((out_dir / ("rank%d.json" % r)).read_text())
             for r in range(NPROC)]
    return ranks, jax_runs, plain


def test_pack_ran_four_gloo_ranks(pack):
    ranks, _j, _p = pack
    assert [r["rank"] for r in ranks] == list(range(NPROC))
    assert all(r["world"] == NPROC for r in ranks)


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax_pipeline_and_plain(pack, name):
    """Every rank reports the same losses, JAX's pipelined run's and the
    port's unpipelined run's, step after step."""
    ranks, jax_runs, plain = pack
    rtol = CASES[name][3]
    for r in ranks[1:]:
        assert r["losses"][name] == ranks[0]["losses"][name]
    got = ranks[0]["losses"][name]
    np.testing.assert_allclose(got, jax_runs[name][0], rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(got, plain[name][0], rtol=rtol, atol=ATOL)
    assert np.all(np.isfinite(got))


def test_pipeline_matches_plain_training(pack):
    """tests/test_pipeline.py::test_pipeline_matches_plain_training's
    own bound besides: the loss halves over the 8 steps."""
    ranks, _j, _p = pack
    got = ranks[0]["losses"]["plain"]
    assert len(got) == 8 and got[-1] < got[0] * 0.5


_SHAPES = {"w0": (D, H), "b0": (H,), "w1": (H, H), "b1": (H,),
           "w2": (H, H), "b2": (H,), "w3": (H, 1), "b3": (1,)}


def _full(ranks, name, w):
    """Parameter ``w`` of a four-stage case as the world holds it: the
    four stages' slices in stage order when its dim 0 divides by S."""
    parts = [np.asarray(r["weights"][name][w]) for r in ranks]
    return np.concatenate(parts) if _SHAPES[w][0] % S == 0 else parts[0]


@pytest.mark.parametrize("name", ["regularization", "global_norm_clip"])
def test_post_phase_weights_match_jax(pack, name):
    """Weight decay and the whole clip chain (norms, sums, sqrt, scale)
    run in the post phase on the merged gradients: every parameter after
    3 steps, gathered from the four stages' slices, against JAX's."""
    ranks, jax_runs, plain = pack
    rtol = CASES[name][3]
    for w in WEIGHTS:
        got = _full(ranks, name, w)
        np.testing.assert_allclose(got, jax_runs[name][1][w], rtol=rtol,
                                   atol=ATOL)
        np.testing.assert_allclose(got, plain[name][1][w], rtol=rtol,
                                   atol=ATOL)


def test_params_and_accumulators_stored_sharded(pack):
    """Between steps each rank holds 1/S of the rows of every parameter
    whose dim 0 divides by S, and of its Momentum velocity; the rest
    whole.  With shard_params=False every value is whole, and both
    layouts train alike."""
    ranks, _j, _p = pack
    links = ranks[0]["links"]
    checked = 0
    for r in ranks:
        sh = r["shapes"]["momentum"]
        for w, shape in _SHAPES.items():
            want = [shape[0] // S] + list(shape[1:]) \
                if shape[0] % S == 0 and shape[0] >= S else list(shape)
            assert sh[w] == want, (w, sh[w])
            vel = [a for a, p in links.items() if p == w]
            assert vel and all(sh[v] == want for v in vel), (w, vel)
            checked += shape[0] % S == 0
        repl = r["shapes"]["replicated"]
        assert all(repl[w] == list(s) for w, s in _SHAPES.items())
    assert checked >= 3 * NPROC
    np.testing.assert_allclose(ranks[0]["losses"]["replicated"],
                               ranks[0]["losses"]["plain"][:4], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name,partial_norms", [("momentum", 0),
                                                 ("global_norm_clip", 7)])
def test_a_stage_gathers_only_what_it_reads(pack, name, partial_norms):
    """With shard_params a step gathers to stage k only the parameters
    its ops read (w_k and b_k, whole), reduce-scatters the sharded
    gradients back to the slices and runs the post phase on the slices:
    no all-gather over pp.  The all-reduces over pp are the loss, the
    gradient of b3 (the one parameter kept whole) and, under the
    global-norm clip, the partial squared norm of each of the seven
    sharded gradients."""
    ranks, _j, _p = pack
    for r in ranks:
        k = r["rank"]
        comm = r["comm"][name]
        steps = len(r["losses"][name])
        whole = sum(4 * int(np.prod(_SHAPES[w]))
                    for w in ("w%d" % k, "b%d" % k) if _SHAPES[w][0] % S == 0)
        assert comm["gather@pp"] == [steps, steps * whole], (k, comm)
        assert comm["reducescatter@pp"][0] >= steps, (k, comm)
        assert "allgather@pp" not in comm, (k, comm)
        assert comm["allreduce@pp"][0] == steps * (2 + partial_norms), \
            (k, comm)


def test_bf16_boundary_arrives_bit_equal(pack):
    """One microbatch: the pipelined step-1 loss is the unpipelined one
    bit for bit, which it is only if the bf16 boundary crossed exactly;
    the receiving stage got a bf16 tensor."""
    ranks, _j, plain = pack
    assert ranks[0]["losses"]["bf16"][0] == plain["bf16"][0][0]
    receivers = [r for r in ranks if r.get("bf16_in")]
    assert receivers and all(r["bf16_in"] == ["torch.bfloat16"]
                             for r in receivers)


def test_tied_parameter_gets_both_stages_gradient(pack):
    """``tied_w`` is read by both stages: its gradient is the sum of
    theirs, so the losses follow JAX's and the unpipelined run's (a
    stage-local gradient would diverge from step 2)."""
    ranks, jax_runs, plain = pack
    got = ranks[0]["losses"]["tied"]
    np.testing.assert_allclose(got[1:], plain["tied"][0][1:], rtol=RTOL,
                               atol=ATOL)
    assert got[1] != got[0]


def test_dropout_recompute_replays_the_forward_mask(pack):
    """Each microbatch's recomputed stage output equals its forward
    output bit for bit (same mask), the two microbatches of a step draw
    different masks, and about half the activations are dropped."""
    ranks, _j, _p = pack
    senders = [r for r in ranks if r["dropout_recompute_equal"]]
    assert len(senders) == 2                      # stage 0 of each replica
    for r in senders:
        assert len(r["dropout_recompute_equal"]) == 2 * M2
        assert all(r["dropout_recompute_equal"])
        assert all(r["dropout_mask_differs"])
        assert all(0.3 < z < 0.7 for z in r["dropout_zero_share"])
    assert np.all(np.isfinite(ranks[0]["losses"]["dropout"]))


def test_run_window_is_bit_equal_to_single_runs(pack):
    ranks, _j, _p = pack
    for r in ranks:
        assert r["losses"]["window"] == r["losses"]["window_runs"]
        assert len(r["losses"]["window"]) == 4


def test_phase_spans_are_recorded(pack):
    """With spans on, every step records its five phases on each rank,
    labelled with the rank's stage (ranks 0 and 2 run stage 0)."""
    ranks, _j, _p = pack
    phases = ["pipeline_" + p for p in ("backward", "forward", "gather",
                                        "merge", "update")]
    for r in ranks:
        stage = r["rank"] % 2
        assert r["spans"] == [[p, stage] for p in phases]


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_with_jax_error(pack, name):
    """Every rank raises the JAX package's error type and message, and
    the JAX package raises them for the same program."""
    ranks, _j, _p = pack
    make, fetch, kind, msg = REFUSED[name]
    for r in ranks:
        assert r["errors"][name] is not None
        assert r["errors"][name][0] == kind and msg in r["errors"][name][1]
    import paddle_tpu.fluid as jfluid
    main, startup, loss = build(jfluid, make)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    target = loss if fetch else main.global_block().ops[0].output("Out")[0]
    error = {"TypeError": TypeError,
             "NotImplementedError": NotImplementedError}[kind]
    with pytest.raises(error, match=msg):
        exe.run(main, feed=two_feeds(1)[0], fetch_list=[target],
                scope=scope)


def test_non_chain_cuts_refused_with_jax_message():
    """tests/test_pipeline.py::test_pipeline_rejects_non_chain_cuts in
    both packages (the plan is checked before the world is asked for)."""
    import paddle_tpu.fluid as jfluid
    for pkg in (jfluid, fluid):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            with pkg.device_guard("pp:0"):
                x = L.data(name="x", shape=[B, D], dtype="float32",
                           append_batch_size=False)
                h0 = L.fc(input=x, size=H)
            with pkg.device_guard("pp:1"):
                h1 = L.fc(input=h0, size=H)
            with pkg.device_guard("pp:2"):
                y = L.data(name="y", shape=[B, 1], dtype="float32",
                           append_batch_size=False)
                bad = L.elementwise_add(h1, h0)
                pred = L.fc(input=bad, size=1)
                loss = L.reduce_mean(L.square_error_cost(pred, y))
            pkg.optimizer.PipelineOptimizer(
                pkg.optimizer.SGDOptimizer(0.1),
                num_microbatches=M).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="pipeline cuts must form a "
                                             "chain"):
            exe.run(main, feed={"x": np.zeros((B, D), np.float32),
                                "y": np.zeros((B, 1), np.float32)},
                    fetch_list=[loss], scope=scope)


def test_one_stage_pipeline_runs_in_a_world_of_one():
    """A PipelineOptimizer program with no ``device_guard`` is one stage:
    it needs no world, and its microbatched steps follow JAX's pipelined
    run and the port's plain run."""
    def make(pipeline):
        def b(pkg):
            L = pkg.layers
            x = L.data(name="x", shape=[B2, H], dtype="float32",
                       append_batch_size=False)
            y = L.data(name="y", shape=[B2, 1], dtype="float32",
                       append_batch_size=False)
            h = L.fc(x, size=H, act="tanh")
            loss = L.reduce_mean(L.square_error_cost(L.fc(h, size=1), y))
            inner = pkg.optimizer.SGDOptimizer(0.1)
            if pipeline:
                inner = pkg.optimizer.PipelineOptimizer(
                    inner, num_microbatches=M2)
            inner.minimize(loss)
            return loss
        return b
    feeds = two_feeds(3)
    init, run = jax_prepare(make(True))
    ref = run(feeds)[0]
    got = port_plain(make(True), feeds, init)[0]
    plain = port_plain(make(False), feeds, init)[0]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


def test_stage_annotation_and_config_match_jax():
    """``device_guard`` stamps the same ``pipeline_stage`` on the same
    ops, and ``PipelineOptimizer`` writes the same config, in both
    packages; a world smaller than the stages is refused with JAX's
    RuntimeError."""
    import paddle_tpu.fluid as jfluid
    got = {}
    for pkg in (jfluid, fluid):
        main, _s, loss = build(pkg, mlp())
        got[pkg.__name__] = (
            [(op.type, op.attr("pipeline_stage")) for op in
             main.global_block().ops],
            main._pipeline_config)
    assert got["paddle_tpu.fluid"] == got["paddle_tpu_torch.fluid"]
    assert got["paddle_tpu_torch.fluid"][1] == {
        "num_microbatches": M, "loss_name": loss.name, "shard_params": True}
    main, startup, loss = build(fluid, mlp())
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="pipeline needs 4 stages x "
                                           "mp=1 x sp=1 x ep=1 = 4 "
                                           "devices, have 1"):
        exe.run(main, feed=mlp_feeds(1)[0], fetch_list=[loss], scope=scope)


def test_rebased_mask_pos_reads_the_same_rows():
    """The re-based indices address, inside each microbatch's
    ``[(B/M)·S, H]`` output, the rows the original ones address in the
    whole ``[B·S, H]``."""
    cfg = bert_config()
    f = bert_feeds(1)[0]
    r = rebase_mask_pos(f, M2, cfg.max_seq_len)
    rows = BERT_ROWS // M2 * cfg.max_seq_len
    per = len(f["mask_pos"]) // M2
    for k in range(M2):
        got = r["mask_pos"][k * per:(k + 1) * per] + k * rows
        np.testing.assert_array_equal(got, f["mask_pos"][k * per:
                                                         (k + 1) * per])
        assert (r["mask_pos"][k * per:(k + 1) * per] < rows).all()
        assert (r["mask_pos"] >= 0).all()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
