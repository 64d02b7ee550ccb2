"""Weight-update sharding (ZeRO-1) in the port: ``GradAllReduce(
weight_update_sharding=True)``, ``BuildStrategy.zero_shard_optimizer_state``
and the fleet knob, against paddle_tpu (tests/test_weight_update_sharding
.py, tests/test_zero_sharding.py).

One 2-process gloo pack (this file is its worker) runs every port side
from the JAX package's startup parameters; JAX runs the same programs
transpiled for ``nranks=2`` on the virtual CPU mesh, fed the global batch.

- The MLP of tests/test_weight_update_sharding.py (16 → 32 relu → 1,
  Adam), 8 steps: fp32 sharded is BIT-equal to the replicated
  GradAllReduce of the same pack (losses and parameters), one bucket and
  per gradient (4 buckets); each rank holds its half of the Adam moments
  (the ``(Bp / 2,)`` slices, padding included) and reports about half the
  replicated run's ``optimizer_state_bytes``; the reduce-scatter and
  all-gather move the replaced all-reduce's bytes, up to the bucket's
  pad.  Against JAX's sharded run: losses ``rtol 1e-5``, parameters
  ``atol 1e-5``.
- The int8 wire (block 64), 10 steps: both error-feedback residuals (the
  replicated reduce-scatter one, the sharded all-gather one) are live,
  the loss falls below 0.6 of its start, each step's loss is within
  ``INT8_LOSS_RTOL`` of the fp32 sharded run's (the bound the card's
  BERT-base run is held to), and within it of JAX's int8 run.
  ``run_window`` of 4 steps is bit-equal to 4 ``run`` calls.  The bf16
  wire (the gradient and the parameter delta cast), 8 steps: each loss
  within ``BF16_LOSS_RTOL`` of fp32 and of JAX's bf16 run.
- ``with_data_parallel`` under ``zero_shard_optimizer_state``: bit-equal
  to the replicated ``with_data_parallel``, the per-parameter moments
  gone from the scope; against JAX's GSPMD ZeRO-1 over the global batch,
  the mean of the ranks' losses ``rtol 1e-4, atol 1e-5``.
- The tiny Transformer NMT (Noam-scheduled Adam, every parameter in one
  bucket), 3 steps: sharded bit-equal to the plain GradAllReduce, and on
  the int8 wire each loss within ``INT8_LOSS_RTOL`` of fp32.  Tiny BERT
  through ``fleet.distributed_optimizer`` on the int8 wire: each loss
  within ``INT8_LOSS_RTOL`` of the fp32 fleet run.  BERT's word
  embedding is tied to its output projection, so its gradient is a sum
  of two backward contributions, and weight-update sharding refuses it
  in both packages (in this process).
- A pod checkpoint of the sharded state (barriered save) resumes into a
  fresh scope and continues bit-equal to the uninterrupted run.

In this process: the transpiled structure (tests/test_weight_update_
sharding.py::test_wus_transpiler_structure), and the refusals: an
optimizer that is not elementwise (Lamb), a gradient that something
else reads first (a gradient clip, L2Decay), a gradient summed from
several contributions (BERT's tied embedding), a hierarchical ring.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import bert, transformer

from test_torch_collective_ops import pack_logs, run_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_data_parallel import BERT_STEPS, bert_feed, bert_programs
from test_torch_transformer_training import make_feed

NPROC = 2
ROWS = 4                      # per rank
STEPS, INT8_STEPS, WIN_K = 8, 10, 4
# int8 + error feedback against fp32, per step: the relative loss change
# that one quantization step of 1/127 of a block's largest gradient may
# cause, with a factor 2 for the requantized gather of the update
INT8_LOSS_RTOL = 2.0 / 127
# the same for the bf16 wire: one bf16 rounding (2^-8) of the gradient
# and of the update, twice
BF16_LOSS_RTOL = 2.0 ** -7


def mlp(pkg, optimizer=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=32, act="relu")
        pred = pkg.layers.fc(h, size=1)
        d = pred - y
        loss = pkg.layers.mean(d * d)
        (optimizer or pkg.optimizer.AdamOptimizer(1e-2)).minimize(loss)
    return main, startup, loss


def transpile(pkg, main, startup, **kw):
    pkg.transpiler.GradAllReduce(**kw).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["e"] * NPROC)


def feeds(rank=None):
    rng = np.random.RandomState(0)
    xs = rng.randn(NPROC * ROWS, 16).astype(np.float32)
    ys = (xs @ rng.randn(16, 1)).astype(np.float32)
    if rank is None:
        return {"x": xs, "y": ys}
    rows = slice(rank * ROWS, (rank + 1) * ROWS)
    return {"x": xs[rows], "y": ys[rows]}


def nmt_feed(cfg, rank):
    """Rank ``rank``'s half of a batch of 4 pairs."""
    return {k: v[rank * 2:(rank + 1) * 2]
            for k, v in make_feed(cfg, batch=4, seed=3).items()}


PARAMS = ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0")
# tag -> GradAllReduce keywords
RUNS = {
    "rep": {},
    "wus": dict(weight_update_sharding=True),
    "rep0": dict(fuse_grad_size_mb=0),
    "wus0": dict(weight_update_sharding=True, fuse_grad_size_mb=0),
    "wus8": dict(weight_update_sharding=True, allreduce_precision="int8",
                 quant_block_size=64),
    "wus16": dict(weight_update_sharding=True, allreduce_precision="bf16"),
}


# ---------------------------------------------------------------------------
# The pack's worker
# ---------------------------------------------------------------------------

def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist, telemetry
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker
    from paddle_tpu_torch.fluid.incubate.fleet.collective import (
        DistributedStrategy, fleet)
    out_dir = Path(out_dir)
    rank, n = dist.init(backend="gloo")
    place = fluid.CPUPlace()
    exe = fluid.Executor(place)
    init = dict(np.load(out_dir / "init_mlp.npz"))
    res, arrays = {"rank": rank, "world": n}, {}

    def fresh(startup):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.load_numpy_params(scope, init, place)
        return scope

    def step(prog, scope, loss, feed=None):
        return float(exe.run(prog, feed=feed or feeds(rank),
                             fetch_list=[loss], scope=scope)[0]
                     .reshape(-1)[0])

    for tag, kw in RUNS.items():
        main, startup, loss = mlp(fluid)
        transpile(fluid, main, startup, **kw)
        scope = fresh(startup)
        steps = INT8_STEPS if tag == "wus8" else STEPS
        r = dict(losses=[step(main, scope, loss) for _ in range(steps)])
        ev = telemetry.step_events()[-1]
        r.update(opt_bytes=ev["opt_state_bytes"], comm=ev["comm_by"],
                 ops=[op.type for op in main.global_block().ops],
                 shapes={v: list(scope.find_var(v).shape)
                         for v in sorted(main._dp_sharded_state)},
                 in_scope=sorted(scope.var_names()))
        for p in PARAMS:
            arrays["%s/%s" % (tag, p)] = scope.find_var(p).numpy()
        for v in main._dp_sharded_state | set(main._wus_padded_numel):
            arrays["%s/%s" % (tag, v)] = scope.find_var(v).numpy()
        res[tag] = r

    # run_window over the int8 program: K steps == K runs
    main, startup, loss = mlp(fluid)
    transpile(fluid, main, startup, **RUNS["wus8"])
    win = {}
    for mode in ("run", "window"):
        scope = fresh(startup)
        if mode == "run":
            got = [step(main, scope, loss) for _ in range(WIN_K)]
        else:
            stacked = {k: np.stack([v] * WIN_K)
                       for k, v in feeds(rank).items()}
            out, = exe.run_window(main, feed=stacked, fetch_list=[loss],
                                  scope=scope, steps_per_run=WIN_K)
            got = [float(v) for v in out.reshape(-1)]
        win[mode] = dict(losses=got, w=scope.find_var("fc_0.w_0")
                         .numpy().tolist(),
                         res=scope.find_var("wus_param_0@EF_RESIDUAL")
                         .numpy().tolist())
    res["window"] = win

    # ZeRO-1 under with_data_parallel, against the replicated one
    for tag in ("compiled", "zero"):
        main, startup, loss = mlp(fluid)
        scope = fresh(startup)
        bs = fluid.BuildStrategy()
        bs.zero_shard_optimizer_state = tag == "zero"
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        res[tag] = dict(losses=[step(prog, scope, loss)
                                for _ in range(STEPS)],
                        in_scope=sorted(scope.var_names()),
                        sharded=sorted(prog._dp[1]._dp_sharded_state))
        res[tag]["w"] = scope.find_var("fc_0.w_0").numpy().tolist()

    # a pod checkpoint of the sharded state resumes bit for bit
    main, startup, loss = mlp(fluid)
    transpile(fluid, main, startup, **RUNS["wus"])
    scope = fresh(startup)
    for _ in range(3):
        step(main, scope, loss)
    ck = out_dir / "wus_ckpt"
    mgr = fluid.CheckpointManager(str(ck), main_program=main, place=place)
    mgr.save(scope=scope, sync=True)
    want = [step(main, scope, loss) for _ in range(3)]
    scope2 = fresh(startup)
    meta = fluid.CheckpointManager(str(ck), main_program=main,
                                   place=place).resume(scope=scope2)
    got = [step(main, scope2, loss) for _ in range(3)]
    res["ckpt"] = dict(want=want, got=got, step=meta["step"],
                       process_count=meta["process_count"])

    # tiny Transformer NMT (Noam-scheduled Adam): plain, sharded, and
    # sharded on the int8 wire
    ncfg = transformer.tiny_config(dropout=0.0)
    nfeed = nmt_feed(ncfg, rank)
    for tag, kw in (("nmt", {}), ("nmt_wus", RUNS["wus"]),
                    ("nmt_wus8", dict(weight_update_sharding=True,
                                      allreduce_precision="int8"))):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            out = transformer.build_train(ncfg, lr=2.0, warmup_steps=4)
        transpile(fluid, main, startup, **kw)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        res[tag] = [step(main, scope, out["loss"], nfeed)
                    for _ in range(BERT_STEPS)]
        arrays[tag + "/w"] = np.concatenate([
            scope.find_var(p.name).numpy().reshape(-1)
            for p in main.global_block().all_parameters()])
        res[tag + "_adam"] = [op.type for op in main.global_block().ops] \
            .count("adam")
    # tiny BERT through fleet on the fp32 and the int8 wire (weight-update
    # sharding refuses BERT's tied word embedding, as in the JAX package)
    fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
    binit = dict(np.load(out_dir / "init_bert.npz"))
    for tag, kw in (("bert", {}),
                    ("bert8", dict(allreduce_precision="int8"))):
        opt = fleet.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(learning_rate=1e-3),
            DistributedStrategy(**kw))
        main, startup, out = bert_programs(fluid, bert, optimizer=opt)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.load_numpy_params(scope, binit, place)
        feed = bert_feed(out["config"], rank)
        res[tag] = [step(main, scope, out["loss"], feed)
                    for _ in range(BERT_STEPS)]
    res["torch_threads"] = torch.get_num_threads()
    np.savez(out_dir / ("rank%d.npz" % rank), **arrays)
    with open(out_dir / ("rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


# ---------------------------------------------------------------------------
# The JAX side and the pack
# ---------------------------------------------------------------------------

def _jax_run(init, kw, steps, compiled=False):
    import paddle_tpu.fluid as jfluid
    main, startup, loss = mlp(jfluid)
    if not compiled:
        transpile(jfluid, main, startup, **kw)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for p in PARAMS:
        scope.set_var(p, init[p])
    prog = main
    if compiled:
        bs = jfluid.BuildStrategy()
        bs.zero_shard_optimizer_state = True
        prog = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
    losses = [np.asarray(exe.run(prog, feed=feeds(), fetch_list=[loss],
                                 scope=scope)[0], np.float32).reshape(-1)
              for _ in range(steps)]
    return np.stack(losses), {p: np.asarray(scope.find_var(p))
                              for p in PARAMS}


@pytest.fixture(scope="module")
def wus(tmp_path_factory):
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.models import bert as jbert
    out_dir = tmp_path_factory.mktemp("wus_pack")
    main, startup, _l = mlp(jfluid)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    np.savez(out_dir / "init_mlp.npz",
             **{p: np.asarray(scope.find_var(p)) for p in PARAMS})
    main, startup, _o = bert_programs(jfluid, jbert)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    np.savez(out_dir / "init_bert.npz",
             **{v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars() if v.persistable and
                scope.find_var(v.name) is not None})
    proc = run_pack(Path(__file__), out_dir)
    assert proc.returncode == 0, proc.stderr[-3000:] + pack_logs(out_dir)
    ranks = [json.loads((out_dir / ("rank%d.json" % r)).read_text())
             for r in range(NPROC)]
    arrays = [dict(np.load(out_dir / ("rank%d.npz" % r)))
              for r in range(NPROC)]
    init = dict(np.load(out_dir / "init_mlp.npz"))
    ref = {"wus": _jax_run(init, RUNS["wus"], STEPS),
           "wus8": _jax_run(init, RUNS["wus8"], INT8_STEPS),
           "wus16": _jax_run(init, RUNS["wus16"], STEPS),
           "zero": _jax_run(init, {}, STEPS, compiled=True)}
    return dict(ranks=ranks, arrays=arrays, ref=ref, dir=out_dir)


def _losses(wus, tag):
    return np.array([r[tag]["losses"] for r in wus["ranks"]], np.float32).T


# ---------------------------------------------------------------------------
# Pack tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["one_bucket",
                                                      "per_grad"])
def test_fp32_sharded_update_is_bit_equal_to_the_replicated(wus, fused):
    rep, sh = ("rep", "wus") if fused else ("rep0", "wus0")
    np.testing.assert_array_equal(_losses(wus, sh), _losses(wus, rep))
    for a in wus["arrays"]:
        for p in PARAMS:
            np.testing.assert_array_equal(a["%s/%s" % (sh, p)],
                                          a["%s/%s" % (rep, p)])
    ops = wus["ranks"][0][sh]["ops"]
    assert ops.count("c_reducescatter") == ops.count("c_allgather") == \
        ops.count("adam") == (1 if fused else 4)
    assert "c_allreduce_sum" not in ops


def test_each_rank_holds_its_half_of_the_moments(wus):
    # B = 16*32 + 32 + 32 + 1 = 577 logical elements, Bp = 578
    for r in wus["ranks"]:
        assert r["wus"]["shapes"] == {"wus_moment1_0": [289],
                                      "wus_moment2_0": [289]}
        assert not any(n.endswith("_moment1_0") and not n.startswith("wus")
                       for n in r["wus"]["in_scope"])
        # the moments are half; the four beta powers stay whole
        assert r["wus"]["opt_bytes"] == 4 * (2 * 289 + 4 * 2)
        assert r["rep"]["opt_bytes"] == 4 * (2 * 577 + 4 * 2)
    # the two halves of a moment differ (each rank updated its own)
    m0, m1 = (a["wus/wus_moment1_0"] for a in wus["arrays"])
    assert not np.array_equal(m0, m1)


def test_sharded_wire_bytes_equal_the_allreduce(wus):
    ar = wus["ranks"][0]["rep"]["comm"]["allreduce_fp32"]
    rs = wus["ranks"][0]["wus"]["comm"]["reducescatter_fp32"]
    ag = wus["ranks"][0]["wus"]["comm"]["allgather_fp32"]
    assert ar == 2 * 4 * 577
    # the same two phases, over the bucket padded to 578
    assert (rs, ag) == (4 * 578, 4 * 578)


def test_fp32_sharded_matches_paddle_tpu(wus):
    want_l, want_p = wus["ref"]["wus"]
    np.testing.assert_allclose(_losses(wus, "wus"), want_l, rtol=1e-5)
    for a in wus["arrays"]:
        for p in PARAMS:
            np.testing.assert_allclose(a["wus/" + p], want_p[p], atol=1e-5)


def test_int8_trains_with_dual_error_feedback(wus):
    got = _losses(wus, "wus8")
    assert got[-1].mean() < 0.6 * got[0].mean()
    fp32 = _losses(wus, "wus")
    np.testing.assert_allclose(got[:STEPS], fp32, rtol=INT8_LOSS_RTOL)
    for a in wus["arrays"]:
        # the reduce-scatter residual is the whole bucket (padded to
        # N x 64), the all-gather one the rank's half
        assert a["wus8/wus_grad_0@EF_RESIDUAL"].shape == (640,)
        assert a["wus8/wus_param_0@EF_RESIDUAL"].shape == (320,)
        for v in ("wus_grad_0@EF_RESIDUAL", "wus_param_0@EF_RESIDUAL"):
            assert np.any(a["wus8/" + v]), v


def test_int8_matches_paddle_tpu_within_the_bound(wus):
    want, _p = wus["ref"]["wus8"]
    np.testing.assert_allclose(_losses(wus, "wus8"), want,
                               rtol=INT8_LOSS_RTOL)


def test_bf16_gathers_the_update_as_paddle_tpu_does(wus):
    """On the bf16 wire the reduce-scatter casts the gradient and the
    all-gather the parameter delta (never the parameters): each loss
    within BF16_LOSS_RTOL of fp32 and of JAX's bf16 run."""
    got = _losses(wus, "wus16")
    np.testing.assert_allclose(got, _losses(wus, "wus"),
                               rtol=BF16_LOSS_RTOL)
    want, _p = wus["ref"]["wus16"]
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    ops = wus["ranks"][0]["wus16"]["ops"]
    assert ops.count("elementwise_sub") >= 1 and "assign" in ops
    comm = wus["ranks"][0]["wus16"]["comm"]
    assert set(comm) == {"reducescatter_bf16", "allgather_bf16"}


def test_run_window_carries_the_sharded_state(wus):
    for r in wus["ranks"]:
        w = r["window"]
        assert w["window"] == w["run"]


def test_zero1_with_data_parallel(wus):
    z, c = (np.array([r[t]["losses"] for r in wus["ranks"]], np.float32)
            for t in ("zero", "compiled"))
    np.testing.assert_array_equal(z, c)
    for r in wus["ranks"]:
        assert r["zero"]["w"] == r["compiled"]["w"]
        assert r["zero"]["sharded"] == ["wus_moment1_0", "wus_moment2_0"]
        assert "fc_0.w_0_moment1_0" in r["compiled"]["in_scope"]
        assert "fc_0.w_0_moment1_0" not in r["zero"]["in_scope"]
    # JAX's GSPMD ZeRO-1 fetches the global batch's mean loss
    want, _p = wus["ref"]["zero"]
    np.testing.assert_allclose(z.mean(axis=0), want.reshape(-1),
                               rtol=1e-4, atol=1e-5)


def test_pod_checkpoint_of_sharded_state_resumes_bit_for_bit(wus):
    for r in wus["ranks"]:
        assert r["ckpt"]["got"] == r["ckpt"]["want"]
        assert r["ckpt"]["process_count"] == NPROC


def test_nmt_sharded_is_bit_equal_and_int8_within_the_bound(wus):
    for r, a in zip(wus["ranks"], wus["arrays"]):
        assert r["nmt_wus"] == r["nmt"]
        np.testing.assert_array_equal(a["nmt_wus/w"], a["nmt/w"])
        np.testing.assert_allclose(r["nmt_wus8"], r["nmt"],
                                   rtol=INT8_LOSS_RTOL)
        # every parameter in one bucket, updated by one Adam op
        assert r["nmt_wus_adam"] == 1 < r["nmt_adam"]


def test_fleet_bert_on_the_int8_wire_within_the_bound(wus):
    for r in wus["ranks"]:
        assert r["bert8"] != r["bert"]
        np.testing.assert_allclose(r["bert8"], r["bert"],
                                   rtol=INT8_LOSS_RTOL)


# ---------------------------------------------------------------------------
# In-process tests (a world of one; no process group)
# ---------------------------------------------------------------------------

def test_transpiled_structure():
    main, startup, _l = mlp(fluid)
    transpile(fluid, main, startup, weight_update_sharding=True)
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("c_allreduce_sum") == 0
    assert ops.count("c_reducescatter") == ops.count("c_allgather") == \
        ops.count("c_shard_slice") == ops.count("adam") == 1
    assert ops.index("c_reducescatter") < ops.index("adam") < \
        ops.index("c_allgather")
    names = set(main.global_block().vars)
    assert not any("_moment1_" in n and not n.startswith("wus_")
                   for n in names)
    assert main._wus_degree == NPROC
    assert main._dp_sharded_state == {"wus_moment1_0", "wus_moment2_0"}
    assert main._opt_state_of["wus_moment1_0"] in PARAMS
    fills = [op for op in startup.global_block().ops
             if op.type == "fill_constant"
             and op.output("Out") == ["wus_moment1_0"]]
    assert len(fills) == 1
    assert fills[0].attr("shape")[0] * NPROC == \
        startup.global_block().vars["wus_moment1_0"].shape[0]


def _refusal(pkg, what):
    opt = {"lamb": lambda: pkg.optimizer.LambOptimizer(1e-3),
           "l2decay": lambda: pkg.optimizer.SGDOptimizer(
               0.1, regularization=pkg.regularizer.L2Decay(1e-4)),
           "clip": lambda: pkg.optimizer.SGDOptimizer(0.1)}[what]()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        loss = pkg.layers.mean(pkg.layers.fc(x, size=1))
        if what == "clip":
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(1.0))
        opt.minimize(loss)
    kw = {}
    if what == "hierarchical":
        kw = dict(hierarchical_allreduce_nnodes=2)
    pkg.transpiler.GradAllReduce(weight_update_sharding=True).transpile(
        startup_program=startup, main_program=main, rank=0,
        endpoints=["e"] * 4, **kw)


@pytest.mark.parametrize("what,err,match", [
    ("lamb", NotImplementedError, "elementwise"),
    ("l2decay", NotImplementedError, "does not compose|beyond its"),
    ("clip", NotImplementedError, "does not compose|beyond its")])
def test_refusals_match_paddle_tpu(what, err, match):
    import paddle_tpu.fluid as jfluid
    for pkg in (fluid, jfluid):
        with pytest.raises(err, match=match):
            _refusal(pkg, what)


def test_bert_tied_embedding_is_refused_as_in_paddle_tpu():
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.models import bert as jbert
    for pkg, mod in ((fluid, bert), (jfluid, jbert)):
        main, startup, _o = bert_programs(pkg, mod)
        with pytest.raises(NotImplementedError,
                           match="word_embedding@GRAD@SUM"):
            transpile(pkg, main, startup, weight_update_sharding=True)


def test_hierarchical_ring_is_refused():
    main, startup, _l = mlp(fluid)
    with pytest.raises(ValueError, match="hierarchical"):
        fluid.transpiler.GradAllReduce(weight_update_sharding=True) \
            .transpile(startup_program=startup, main_program=main, rank=0,
                       endpoints=["e"] * 4, hierarchical_allreduce_nnodes=2)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
