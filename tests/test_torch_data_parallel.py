"""Synchronous data parallel in the port (``transpiler.GradAllReduce`` /
``LocalSGD``, ``sync_batch_norm``, ``CompiledProgram.with_data_parallel``,
``ParallelExecutor``, the collective fleet, ``train_from_dataset``'s stop
consensus) in a world of two ranks against paddle_tpu with ``nranks=2``.

One 2-process gloo pack (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2``; this file is its worker) runs every port side; the
JAX side runs in this process on the virtual CPU mesh, fed the global
batch — the ranks' local batches concatenated.  Each program starts from
JAX's startup persistables, carried to both ranks.  Rank r's fetched
loss is JAX replica r's (the JAX package's multi-host contract: each
rank feeds and fetches its local rows).

- fc + SGD, per-gradient and fused GradAllReduce, 5 steps: per-rank
  losses ``rtol 1e-5`` against JAX, and their mean against one process
  training on the whole batch (``test_grad_allreduce_matches_large_batch
  _sgd``'s oracle), parameters ``atol 1e-6``; the same transpiled with
  no endpoints (``nranks=0``), against JAX's run over all 8 replicas.
- tiny BERT (2 layers, width 64, dropout off), 3 Adam steps through
  ``fleet.distributed_optimizer``: losses ``rtol 1e-5``, parameters
  ``1e-4`` relative L2 plus an absolute 1e-7 of L2 for the key
  projections' biases, whose gradient is rounding noise of ~1e-12 in both
  packages and whose values stay ~1e-8 (tests/test_torch_bert_training.py
  says why).
- conv + batch norm + Momentum under ``GradAllReduce(sync_batch_norm=
  True)``, and through ``with_data_parallel`` against JAX's GSPMD
  ``with_data_parallel`` over the global batch, 3 steps: losses ``rtol
  1e-5``, parameters and running statistics ``rtol 1e-4, atol 1e-6``.
- sync batch norm over unequal local batches (3 and 5 rows): each
  rank's rows of one batch norm over all 8, ``rtol 1e-5, atol 1e-6``.
- LocalSGD (``k_steps=2``), 4 steps: losses ``rtol 1e-5``, rank 0's
  parameters (JAX keeps replica 0's) ``atol 1e-6``.
- port-only: ``run_window`` over the transpiled program is bit-equal to
  K ``run`` calls and issues K times the collectives; ranks draw
  different dropout masks and rank 0 the world-of-one mask;
  ``train_from_dataset`` with a stop requested on rank 1 only ends both
  ranks at the same step; ``ParallelExecutor``.

In this process (no process group): the transpiled programs equal the
JAX package's op for op, and the options of ROADMAP items 10b, 11 and
13b raise naming them.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import bert

from test_torch_collective_ops import pack_logs, run_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

NPROC = 2
FC_ROWS, FC_STEPS = 16, 5
CONV_ROWS, CONV_STEPS = 4, 3
BERT_ROWS, BERT_STEPS, BERT_PRED, BERT_LR = 2, 3, 4, 1e-3
LSGD_STEPS = 4
DS_LINES, DS_BATCH, DS_K = 40, 2, 4


# ---------------------------------------------------------------------------
# Programs and feeds, built the same way in both packages
# ---------------------------------------------------------------------------

def fc_net(pkg):
    x = pkg.layers.data(name="x", shape=[6], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="float32")
    pred = pkg.layers.fc(
        x, size=1,
        param_attr=pkg.ParamAttr(
            initializer=pkg.initializer.ConstantInitializer(0.5)),
        bias_attr=pkg.ParamAttr(
            initializer=pkg.initializer.ConstantInitializer(0.0)))
    d = pred - y
    loss = pkg.layers.mean(d * d)
    pkg.optimizer.SGDOptimizer(0.05).minimize(loss)
    return loss


def conv_net(pkg):
    img = pkg.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                          bias_attr=False)
    b = pkg.layers.batch_norm(c, act="relu")
    p = pkg.layers.pool2d(b, pool_size=2, pool_type="max", pool_stride=2)
    logits = pkg.layers.fc(p, size=3)
    loss = pkg.layers.mean(
        pkg.layers.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return loss


def programs(pkg, net):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = net(pkg)
    return main, startup, loss


def fc_feed(rank=None):
    rng = np.random.RandomState(7)
    xs = rng.normal(size=(NPROC * FC_ROWS, 6)).astype(np.float32)
    ws = rng.normal(size=(6, 1)).astype(np.float32)
    ys = (xs @ ws + 0.1 * rng.normal(size=(NPROC * FC_ROWS, 1))) \
        .astype(np.float32)
    if rank is None:
        return {"x": xs, "y": ys}
    rows = slice(rank * FC_ROWS, (rank + 1) * FC_ROWS)
    return {"x": xs[rows], "y": ys[rows]}


def conv_feed(step, rank=None):
    rng = np.random.RandomState(100 + step)
    n = NPROC * CONV_ROWS
    feed = {"img": rng.randn(n, 3, 8, 8).astype(np.float32) * 2 + 0.5,
            "label": rng.randint(0, 3, (n, 1)).astype(np.int64)}
    if rank is None:
        return feed
    return {k: v[rank * CONV_ROWS:(rank + 1) * CONV_ROWS]
            for k, v in feed.items()}


def bn_program(pkg):
    """One batch norm in train mode, forward only."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4, 3, 3], dtype="float32")
        y = pkg.layers.batch_norm(x)
    return main, startup, y


def bn_rows(rank=None):
    """Unequal local batches: rank r holds 3 + 2r rows of the 8."""
    xs = np.random.RandomState(11).randn(8, 4, 3, 3).astype(np.float32)
    xs = xs * np.float32(3) + np.float32(1)
    return xs if rank is None else xs[(0, 3)[rank]:(3, 8)[rank]]


def bert_feed(cfg, rank=None):
    """Rank r's pretraining batch (tests/test_torch_bert_training.py's
    make_feed, seeded by the rank); mask_pos indexes the rank's own rows,
    so the global batch is the ranks' batches concatenated as they
    are."""
    if rank is not None:
        rng = np.random.RandomState(rank)
        S, B, P = cfg.max_seq_len, BERT_ROWS, BERT_PRED
        lengths = rng.randint(S // 2, S + 1, B)
        pos = np.stack([rng.choice(n, P, replace=False) + i * S
                        for i, n in enumerate(lengths)])
        return {
            "src_ids": rng.randint(0, cfg.vocab_size, (B, S, 1)),
            "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (B, 1, 1)),
            "sent_ids": rng.randint(0, 2, (B, S, 1)),
            "input_mask": (np.arange(S)[None, :, None] <
                           lengths[:, None, None]).astype(np.float32),
            "mask_pos": pos.reshape(-1, 1).astype(np.int32),
            "mask_label": rng.randint(0, cfg.vocab_size, (B * P, 1)),
            "nsp_label": rng.randint(0, 2, (B, 1)),
        }
    fs = [bert_feed(cfg, r) for r in range(NPROC)]
    return {k: np.concatenate([f[k] for f in fs]) for k in fs[0]}


def bert_programs(pkg, bert_mod, optimizer=None):
    cfg = bert_mod.tiny_config(hidden_dropout=0.0, attn_dropout=0.0)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = bert_mod.build_pretrain(cfg, lr=BERT_LR,
                                      max_pred_per_seq=BERT_PRED,
                                      optimizer=optimizer)
    return main, startup, out


def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def write_multislot(path, rank):
    rng = np.random.RandomState(50 + rank)
    with open(path, "w") as f:
        for _ in range(DS_LINES):
            x = rng.randn(6)
            f.write("6 %s 1 %.6g\n" % (" ".join("%.6g" % v for v in x),
                                       float(x.sum())))


# ---------------------------------------------------------------------------
# The pack's worker
# ---------------------------------------------------------------------------

def _loss(v):
    return float(np.asarray(v).reshape(-1)[0])


def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist, preemption
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker
    from paddle_tpu_torch.fluid.incubate.fleet.collective import fleet
    from paddle_tpu_torch.fluid.ops import collective_ops
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce, LocalSGD
    out_dir = Path(out_dir)
    rank, n = dist.init(backend="gloo")
    place = fluid.CPUPlace()
    exe = fluid.Executor(place)
    res, arrays = {"rank": rank, "world": n}, {}

    def init_scope(startup, name):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = dict(np.load(out_dir / ("init_%s.npz" % name)))
        fluid.load_numpy_params(scope, init, place)
        return scope

    def keep(tag, main, scope):
        for v in persistables(main):
            t = scope.find_var(v)
            if t is not None and t.is_floating_point():
                arrays["%s/%s" % (tag, v)] = t.numpy()

    # fc + SGD under GradAllReduce, per gradient and fused, transpiled
    # for this world and, with no endpoints, for any (nranks=0)
    for fuse in (0, 32):
        for tag, endpoints in (("fc%d" % fuse, ["e"] * n),
                               ("fc%d_any" % fuse, None)):
            main, startup, loss = programs(fluid, fc_net)
            GradAllReduce(fuse_grad_size_mb=fuse).transpile(
                startup, main, rank=rank, endpoints=endpoints)
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            collective_ops.reset_calls()
            res[tag] = [_loss(exe.run(main, feed=fc_feed(rank),
                                      fetch_list=[loss], scope=scope)[0])
                        for _ in range(FC_STEPS)]
            res[tag + "_calls"] = dict(collective_ops.calls)
            keep(tag, main, scope)

    # run_window over the fused program: K=2 against two run() calls
    main, startup, loss = programs(fluid, fc_net)
    GradAllReduce().transpile(startup, main, rank=rank, endpoints=["e"] * n)
    window = {}
    for mode in ("run", "window"):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        collective_ops.reset_calls()
        feed = fc_feed(rank)
        if mode == "run":
            got = [_loss(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]) for _ in range(2)]
        else:
            stacked = {k: np.stack([v, v]) for k, v in feed.items()}
            out, = exe.run_window(main, feed=stacked, fetch_list=[loss],
                                  scope=scope, steps_per_run=2)
            got = [float(v) for v in out.reshape(-1)]
        window[mode] = dict(losses=got, calls=dict(collective_ops.calls),
                            w=scope.find_var("fc_0.w_0").numpy().tolist())
    res["window"] = window

    # tiny BERT through fleet: PaddleCloudRoleMaker reads the launcher's
    # environment; fleet.init joins the (already gloo) world
    fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
    res["fleet"] = dict(index=fleet.worker_index(), num=fleet.worker_num())
    opt = fleet.distributed_optimizer(
        fluid.optimizer.AdamOptimizer(learning_rate=BERT_LR))
    main, startup, out = bert_programs(fluid, bert, optimizer=opt)
    res["bert_ops"] = [op.type for op in main.global_block().ops]
    scope = init_scope(startup, "bert")
    feed = bert_feed(out["config"], rank)
    res["bert"] = [_loss(exe.run(main, feed=feed, fetch_list=[out["loss"]],
                                 scope=scope)[0])
                   for _ in range(BERT_STEPS)]
    keep("bert", main, scope)
    # the chief alone writes; every rank sees the files after the barrier
    save_dir = out_dir / "fleet_save"
    writes = []
    real_save = fluid.io.save_persistables
    fluid.io.save_persistables = lambda *a, **k: (writes.append(1),
                                                  real_save(*a, **k))
    try:
        with fluid.scope_guard(scope):
            fleet.save_persistables(exe, str(save_dir), main)
    finally:
        fluid.io.save_persistables = real_save
    res["fleet_saves"] = len(writes)
    res["fleet_saved"] = sorted(os.listdir(save_dir))

    # conv + sync batch norm under GradAllReduce, and with_data_parallel
    for tag in ("sync_bn", "compiled"):
        main, startup, loss = programs(fluid, conv_net)
        if tag == "sync_bn":
            GradAllReduce(sync_batch_norm=True).transpile(
                startup, main, rank=rank, endpoints=["e"] * n)
            prog = main
        else:
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
        scope = init_scope(startup, "conv")
        res[tag] = [_loss(exe.run(prog, feed=conv_feed(s, rank),
                                  fetch_list=[loss], scope=scope)[0])
                    for s in range(CONV_STEPS)]
        keep(tag, main, scope)
        if tag == "compiled":
            res["compiled_ops"] = [op.type for op in
                                   prog._dp[1].global_block().ops]

    # sync batch norm over unequal local batches
    main, startup, y = bn_program(fluid)
    fluid.ir.get_pass("sync_batch_norm_pass")(main)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    res["bn_unequal"] = exe.run(main, feed={"x": bn_rows(rank)},
                                fetch_list=[y], scope=scope)[0].tolist()
    res["bn_unequal_ops"] = [op.type for op in main.global_block().ops]

    # LocalSGD, k_steps=2
    main, startup, loss = programs(fluid, fc_net)
    LocalSGD(k_steps=2).transpile(startup, main, rank=rank,
                                  endpoints=["e"] * n)
    scope = init_scope(startup, "fc")
    res["lsgd"] = [_loss(exe.run(main, feed=fc_feed(rank),
                                 fetch_list=[loss], scope=scope)[0])
                   for _ in range(LSGD_STEPS)]
    keep("lsgd", main, scope)

    # ParallelExecutor over the fc program (transpiled copy, parameters
    # broadcast from rank 0 before the first step)
    main, startup, loss = programs(fluid, fc_net)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                    main_program=main)
        res["pe_devices"] = pe.device_count
        res["pe"] = [_loss(pe.run([loss], feed=fc_feed(rank))[0])
                     for _ in range(FC_STEPS)]

    # dropout: a different mask on each rank
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.dropout(x, dropout_prob=0.5)
    res["dropout"] = exe.run(main, feed={"x": np.ones((4, 64), np.float32)},
                             fetch_list=[y], scope=fluid.Scope())[0].tolist()

    # train_from_dataset: a stop requested on rank 1 only
    main, startup, loss = programs(fluid, fc_net)
    GradAllReduce().transpile(startup, main, rank=rank, endpoints=["e"] * n)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    path = str(out_dir / ("part-%d.txt" % rank))
    write_multislot(path, rank)
    ds = fluid.DatasetFactory().create_dataset("FileInstantDataset")
    ds.set_batch_size(DS_BATCH)
    ds.set_filelist([path])
    blk = main.global_block()
    ds.set_use_var([blk.var("x"), blk.var("y")])
    if rank == 1:
        preemption.request_stop()
    res["dataset"] = exe.train_from_dataset(main, ds, scope=scope,
                                            steps_per_run=DS_K)
    preemption.clear()
    res["dataset_step"] = int(scope.step_counter)
    res["dataset_w"] = scope.find_var("fc_0.w_0").numpy().tolist()
    try:
        exe.train_from_dataset(main, ds, scope=scope,
                               checkpoint_manager=object())
        res["dataset_ckpt"] = None
    except NotImplementedError as e:
        res["dataset_ckpt"] = str(e)

    res["torch_threads"] = torch.get_num_threads()
    np.savez(out_dir / ("rank%d.npz" % rank), **arrays)
    with open(out_dir / ("rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


# ---------------------------------------------------------------------------
# The JAX side and the pack
# ---------------------------------------------------------------------------

def _jax_startup(jfluid, main, startup):
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return scope, {n: np.asarray(scope.find_var(n))
                   for n in persistables(main)
                   if scope.find_var(n) is not None}


def _jax_after(scope, main):
    return {n: np.asarray(scope.find_var(n)) for n in persistables(main)
            if scope.find_var(n) is not None}


def _jax_losses(jfluid, main, scope, feeds, fetch):
    exe = jfluid.Executor(jfluid.CPUPlace())
    return [np.asarray(exe.run(main, feed=f, fetch_list=[fetch],
                               scope=scope)[0], np.float32).reshape(-1)
            for f in feeds]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.transpiler import (GradAllReduce as JGAR,
                                             LocalSGD as JLSGD)
    from paddle_tpu.models import bert as jbert
    out_dir = tmp_path_factory.mktemp("dp_pack")
    ref = {}

    def transpiled(net, make):
        main, startup, loss = programs(jfluid, net)
        if make is not None:
            make().transpile(startup_program=startup, main_program=main,
                             rank=0, endpoints=["e"] * NPROC)
        return main, startup, loss

    # startups first: the pack starts from these persistables
    jobs = {
        "bert": bert_programs(jfluid, jbert),
        "conv": transpiled(conv_net, lambda: JGAR(sync_batch_norm=True)),
        "lsgd": transpiled(fc_net, lambda: JLSGD(k_steps=2)),
    }
    jbert_main, jbert_startup, jbert_out = jobs["bert"]
    JGAR().transpile(startup_program=jbert_startup, main_program=jbert_main,
                     rank=0, endpoints=["e"] * NPROC)
    scopes = {}
    for name, (main, startup, _l) in jobs.items():
        scopes[name], init = _jax_startup(jfluid, main, startup)
        np.savez(out_dir / ("init_%s.npz" % ("fc" if name == "lsgd"
                                             else name)), **init)

    proc = run_pack(Path(__file__), out_dir)
    assert proc.returncode == 0, proc.stderr[-3000:] + pack_logs(out_dir)
    ranks = [json.loads((out_dir / ("rank%d.json" % r)).read_text())
             for r in range(NPROC)]
    arrays = [dict(np.load(out_dir / ("rank%d.npz" % r)))
              for r in range(NPROC)]

    # fc: JAX nranks=2, both layouts, and one process on the whole batch
    for fuse in (0, 32):
        main, startup, loss = transpiled(
            fc_net, lambda: JGAR(fuse_grad_size_mb=fuse))
        scope, _ = _jax_startup(jfluid, main, startup)
        ref["fc%d" % fuse] = _jax_losses(jfluid, main, scope,
                                         [fc_feed()] * FC_STEPS, loss)
        ref["fc%d_after" % fuse] = _jax_after(scope, main)
        # no endpoints: JAX maps every local device (8 replicas here)
        main, startup, loss = programs(jfluid, fc_net)
        JGAR(fuse_grad_size_mb=fuse).transpile(
            startup_program=startup, main_program=main, rank=0)
        scope, _ = _jax_startup(jfluid, main, startup)
        ref["fc%d_any" % fuse] = _jax_losses(jfluid, main, scope,
                                             [fc_feed()] * FC_STEPS, loss)
        ref["fc%d_any_after" % fuse] = _jax_after(scope, main)
    main, startup, loss = programs(jfluid, fc_net)
    scope, _ = _jax_startup(jfluid, main, startup)
    ref["fc_single"] = _jax_losses(jfluid, main, scope,
                                   [fc_feed()] * FC_STEPS, loss)
    # BERT
    ref["bert_ops"] = [op.type for op in jbert_main.global_block().ops]
    ref["bert"] = _jax_losses(
        jfluid, jbert_main, scopes["bert"],
        [bert_feed(jbert_out["config"])] * BERT_STEPS, jbert_out["loss"])
    ref["bert_after"] = _jax_after(scopes["bert"], jbert_main)
    # conv: explicit sync BN, then GSPMD with_data_parallel
    main, _s, loss = jobs["conv"]
    ref["sync_bn"] = _jax_losses(
        jfluid, main, scopes["conv"],
        [conv_feed(s) for s in range(CONV_STEPS)], loss)
    ref["sync_bn_after"] = _jax_after(scopes["conv"], main)
    main, startup, loss = programs(jfluid, conv_net)
    cscope = jfluid.Scope()
    init = dict(np.load(out_dir / "init_conv.npz"))
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=cscope)
    for k, v in init.items():
        cscope.set_var(k, v)
    compiled = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    ref["compiled"] = _jax_losses(
        jfluid, compiled, cscope, [conv_feed(s) for s in range(CONV_STEPS)],
        loss)
    ref["compiled_after"] = _jax_after(cscope, main)
    # LocalSGD
    main, _s, loss = jobs["lsgd"]
    ref["lsgd"] = _jax_losses(jfluid, main, scopes["lsgd"],
                              [fc_feed()] * LSGD_STEPS, loss)
    ref["lsgd_after"] = _jax_after(scopes["lsgd"], main)
    return dict(ranks=ranks, arrays=arrays, ref=ref, dir=out_dir)


def _rank_losses(dp, key):
    return np.array([r[key] for r in dp["ranks"]], np.float32).T


# ---------------------------------------------------------------------------
# Pack tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", [0, 32], ids=["per_grad", "fused"])
def test_grad_allreduce_fc_matches_paddle_tpu(dp, fuse):
    got = _rank_losses(dp, "fc%d" % fuse)
    np.testing.assert_allclose(got, np.stack(dp["ref"]["fc%d" % fuse]),
                               rtol=1e-5)
    # the mean of the ranks' losses is one process's on the whole batch
    np.testing.assert_allclose(got.mean(axis=1),
                               np.concatenate(dp["ref"]["fc_single"]),
                               rtol=1e-5, atol=1e-6)
    want = dp["ref"]["fc%d_after" % fuse]
    for r in range(NPROC):
        for name in ("fc_0.w_0", "fc_0.b_0"):
            np.testing.assert_allclose(
                dp["arrays"][r]["fc%d/%s" % (fuse, name)], want[name],
                atol=1e-6)


@pytest.mark.parametrize("fuse", [0, 32], ids=["per_grad", "fused"])
def test_grad_allreduce_without_endpoints_averages_over_the_world(dp, fuse):
    """Transpiled with no endpoints (nranks=0), the gradient mean
    divides by the world that runs the program (2 ranks here; JAX's by
    its 8 replicas): both train on the global batch's gradient."""
    got = _rank_losses(dp, "fc%d_any" % fuse)
    np.testing.assert_allclose(got, _rank_losses(dp, "fc%d" % fuse),
                               rtol=1e-5)
    # rank r's rows are JAX replicas 4r..4r+3's
    jax = np.stack(dp["ref"]["fc%d_any" % fuse]).reshape(FC_STEPS, NPROC, -1)
    np.testing.assert_allclose(got, jax.mean(axis=2), rtol=1e-5)
    np.testing.assert_allclose(got.mean(axis=1),
                               np.concatenate(dp["ref"]["fc_single"]),
                               rtol=1e-5, atol=1e-6)
    want = dp["ref"]["fc%d_any_after" % fuse]
    for r in range(NPROC):
        assert dp["ranks"][r]["fc%d_any_calls" % fuse] == \
            dp["ranks"][r]["fc%d_calls" % fuse]
        for name in ("fc_0.w_0", "fc_0.b_0"):
            np.testing.assert_allclose(
                dp["arrays"][r]["fc%d_any/%s" % (fuse, name)], want[name],
                atol=1e-6)


@pytest.mark.parametrize("fuse,calls", [(0, 2), (32, 1)],
                         ids=["per_grad", "fused"])
def test_grad_allreduce_issues_one_collective_per_bucket(dp, fuse, calls):
    for r in dp["ranks"]:
        assert r["fc%d_calls" % fuse] == {"c_allreduce_sum":
                                          calls * FC_STEPS}


def test_fleet_save_persistables_is_the_chiefs(dp):
    r0, r1 = dp["ranks"]
    assert (r0["fleet_saves"], r1["fleet_saves"]) == (1, 0)
    # rank 1 lists the chief's files: it passed the barrier after them
    assert r1["fleet_saved"] == r0["fleet_saved"]
    assert any(n.startswith("word_embedding") for n in r0["fleet_saved"])


def test_fleet_bert_matches_paddle_tpu(dp):
    assert [r["fleet"] for r in dp["ranks"]] == [
        {"index": 0, "num": 2}, {"index": 1, "num": 2}]
    # fleet's transpile is GradAllReduce's, as in the JAX package
    assert dp["ranks"][0]["bert_ops"] == dp["ref"]["bert_ops"]
    np.testing.assert_allclose(_rank_losses(dp, "bert"),
                               np.stack(dp["ref"]["bert"]), rtol=1e-5)
    want = dp["ref"]["bert_after"]
    names = [k.split("/", 1)[1] for k in dp["arrays"][0]
             if k.startswith("bert/")]
    assert len(names) > 30
    for r in range(NPROC):
        for n in names:
            a, b = dp["arrays"][r]["bert/" + n], want[n]
            assert np.linalg.norm(a - b) <= \
                1e-4 * np.linalg.norm(b) + 1e-7, n


@pytest.mark.parametrize("tag", ["sync_bn", "compiled"])
def test_conv_batch_norm_matches_paddle_tpu(dp, tag):
    got = _rank_losses(dp, tag)
    ref = np.stack(dp["ref"][tag])
    if tag == "compiled":
        # GSPMD fetches the global batch's mean loss
        got = got.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    want = dp["ref"][tag + "_after"]
    names = [k.split("/", 1)[1] for k in dp["arrays"][0]
             if k.startswith(tag + "/")]
    assert "batch_norm_0.mean" in names and "batch_norm_0.variance" in names
    for r in range(NPROC):
        for n in names:
            np.testing.assert_allclose(dp["arrays"][r][tag + "/" + n],
                                       want[n], rtol=1e-4, atol=1e-6,
                                       err_msg=n)


def test_with_data_parallel_in_a_world_of_two_syncs_batch_norm(dp):
    ops = dp["ranks"][0]["compiled_ops"]
    assert "batch_norm" not in ops
    assert ops.count("sync_batch_norm") == 1
    assert ops.count("sync_batch_norm_grad") == 1
    assert ops.count("c_allreduce_sum") == 1      # one 32 MB bucket


def test_sync_batch_norm_over_unequal_batches_is_the_global_batch_norm(dp):
    """Rank 0 holds 3 rows and rank 1 5: each rank's output is its rows
    of one batch norm over all 8 (the port, no process group)."""
    assert "sync_batch_norm" in dp["ranks"][0]["bn_unequal_ops"]
    main, startup, y = bn_program(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    want = exe.run(main, feed={"x": bn_rows()}, fetch_list=[y],
                   scope=scope)[0]
    got = np.concatenate([np.asarray(r["bn_unequal"], np.float32)
                          for r in dp["ranks"]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_local_sgd_matches_paddle_tpu(dp):
    np.testing.assert_allclose(_rank_losses(dp, "lsgd"),
                               np.stack(dp["ref"]["lsgd"]), rtol=1e-5)
    want = dp["ref"]["lsgd_after"]
    for name in ("fc_0.w_0", "fc_0.b_0"):
        np.testing.assert_allclose(dp["arrays"][0]["lsgd/" + name],
                                   want[name], atol=1e-6)


def test_run_window_is_k_steps_of_run(dp):
    for r in dp["ranks"]:
        w = r["window"]
        assert w["window"]["losses"] == w["run"]["losses"]
        assert w["window"]["w"] == w["run"]["w"]
        assert w["window"]["calls"] == w["run"]["calls"] == \
            {"c_allreduce_sum": 2}


def test_parallel_executor_trains_like_grad_allreduce(dp):
    for r in dp["ranks"]:
        assert r["pe_devices"] == 1
        np.testing.assert_allclose(r["pe"], r["fc32"], rtol=1e-6)


def test_ranks_draw_different_dropout_masks(dp):
    m0, m1 = (np.asarray(r["dropout"]) for r in dp["ranks"])
    assert not np.array_equal(m0 == 0, m1 == 0)
    # rank 0 keeps the world-of-one stream
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        y = fluid.layers.dropout(x, dropout_prob=0.5)
    one = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": np.ones((4, 64), np.float32)}, fetch_list=[y],
        scope=fluid.Scope())[0]
    np.testing.assert_array_equal(m0, one)


def test_train_from_dataset_stop_on_one_rank_drains_both(dp):
    r0, r1 = dp["ranks"]
    # the first consensus boundary is window 16 // K = 4: step 16 of 20
    want = {"steps": 16, "preempted": True, "rollbacks": 0}
    assert r0["dataset"] == r1["dataset"] == want
    assert r0["dataset_step"] == r1["dataset_step"]
    assert r0["dataset_w"] == r1["dataset_w"]
    assert "item 10b" in r0["dataset_ckpt"]


# ---------------------------------------------------------------------------
# In-process tests (a world of one; no process group)
# ---------------------------------------------------------------------------

def _transpile_both(net, make_port, make_jax):
    import paddle_tpu.fluid as jfluid
    out = []
    for pkg, make in ((fluid, make_port), (jfluid, make_jax)):
        main, startup, _l = programs(pkg, net)
        make().transpile(startup_program=startup, main_program=main,
                         rank=0, endpoints=["e"] * NPROC)
        out.append([[(op.type, {k: op.attr(k) for k in (
            "ring_id", "scale", "sections", "shape", "root", "nranks",
            "k_steps", "__grad_bucket__")})
            for op in p.global_block().ops] for p in (main, startup)])
    return out


@pytest.mark.parametrize("net,kind", [
    (fc_net, "per_grad"), (fc_net, "fused"), (conv_net, "per_grad"),
    (conv_net, "fused"), (conv_net, "fused_sync_bn"),
    (conv_net, "per_grad_sync_bn"), (conv_net, "two_rings"),
    (fc_net, "local_sgd"), (conv_net, "bucket_per_grad_size")])
def test_transpiled_programs_equal_paddle_tpu(net, kind):
    from paddle_tpu.fluid import transpiler as jt
    from paddle_tpu_torch.fluid import transpiler as pt
    kw = {"per_grad": dict(fuse_grad_size_mb=0),
          "fused": {}, "fused_sync_bn": dict(sync_batch_norm=True),
          "per_grad_sync_bn": dict(sync_batch_norm=True,
                                   fuse_grad_size_mb=0),
          "two_rings": dict(nrings=2, fuse_grad_size_mb=0),
          # 1 kB buckets: the gradients split over two buckets
          "bucket_per_grad_size": dict(fuse_grad_size_mb=1e-3)}.get(kind)
    if kind == "local_sgd":
        port, jax_ = _transpile_both(net, lambda: pt.LocalSGD(k_steps=2),
                                     lambda: jt.LocalSGD(k_steps=2))
    else:
        port, jax_ = _transpile_both(net, lambda: pt.GradAllReduce(**kw),
                                     lambda: jt.GradAllReduce(**kw))
    assert port == jax_


def test_oversized_gradient_gets_its_own_bucket():
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    main, startup, _l = programs(fluid, conv_net)
    inserts = GradAllReduce()._collect_grads(main.global_block())
    buckets = list(GradAllReduce()._iter_buckets(
        main.global_block(), inserts, 200))
    sizes = [[e[3] * 4 for e in b] for b in buckets]
    assert all(len(b) == 1 for b in sizes if b[0] > 200)
    assert any(len(b) > 1 for b in sizes)
    assert sum(len(b) for b in sizes) == len(inserts)


def test_sync_batch_norm_pass_renames_forward_and_grad():
    main, _s, _l = programs(fluid, conv_net)
    fluid.ir.get_pass("sync_batch_norm_pass")(main)
    ops = [op.type for op in main.global_block().ops]
    assert "batch_norm" not in ops and "batch_norm_grad" not in ops
    assert ops.count("sync_batch_norm") == ops.count(
        "sync_batch_norm_grad") == 1


def test_world_of_one_fleet_trains_with_identity_collectives():
    """fleet with one worker (tests/test_collective.py::
    test_fleet_collective_api): no process group, the c_* ops are the
    identity, and training equals the untranspiled program's."""
    from paddle_tpu_torch.fluid.incubate.fleet.base.role_maker import \
        UserDefinedRoleMaker
    from paddle_tpu_torch.fluid.incubate.fleet.collective import fleet
    fleet.init(UserDefinedRoleMaker(current_id=0, worker_num=1))
    losses = {}
    for tag in ("fleet", "plain"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            d = fluid.layers.fc(x, size=1) - y
            loss = fluid.layers.mean(d * d)
            opt = fluid.optimizer.SGDOptimizer(0.05)
            if tag == "fleet":
                opt = fleet.distributed_optimizer(opt)
            opt.minimize(loss)
        if tag == "fleet":
            assert "c_allreduce_sum" in [
                op.type for op in main.global_block().ops]
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        losses[tag] = [float(exe.run(main, feed=fc_feed(0),
                                     fetch_list=[loss],
                                     scope=scope)[0].reshape(-1)[0])
                       for _ in range(3)]
    assert losses["fleet"] == losses["plain"]
    assert not fluid.distributed.process_count() > 1


def test_compiled_program_in_a_world_of_one_is_the_plain_program():
    main, startup, loss = programs(fluid, conv_net)
    exe = fluid.Executor(fluid.CPUPlace())
    got = {}
    for tag in ("plain", "compiled"):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        prog = main if tag == "plain" else fluid.CompiledProgram(main) \
            .with_data_parallel(loss_name=loss.name)
        got[tag] = [float(exe.run(prog, feed=conv_feed(s, 0),
                                  fetch_list=[loss],
                                  scope=scope)[0].reshape(-1)[0])
                    for s in range(2)]
    assert got["compiled"] == got["plain"]


@pytest.mark.parametrize("what", [
    "weight_update_sharding", "int8", "hierarchical", "fleet_mp",
    "fleet_hierarchical", "fleet_wus", "zero_shard", "places",
    "parameter_server"])
def test_unported_options_raise_naming_their_item(what):
    from paddle_tpu_torch.fluid.incubate.fleet.collective import (
        CollectiveOptimizer, DistributedStrategy)
    from paddle_tpu_torch.fluid.incubate.fleet.parameter_server import \
        fleet as ps_fleet
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    main, startup, loss = programs(fluid, fc_net)
    item, err = "item 10b", NotImplementedError
    if what == "weight_update_sharding":
        call = lambda: GradAllReduce(weight_update_sharding=True)  # noqa
    elif what == "int8":
        call = lambda: GradAllReduce(allreduce_precision="int8")  # noqa
    elif what == "hierarchical":
        call = lambda: GradAllReduce().transpile(  # noqa
            startup, main, endpoints=["e"] * 4,
            hierarchical_allreduce_nnodes=2)
    elif what.startswith("fleet_"):
        strategy = {"fleet_mp": DistributedStrategy(mp_degree=2),
                    "fleet_hierarchical": DistributedStrategy(
                        use_hierarchical_allreduce=True),
                    "fleet_wus": DistributedStrategy(
                        weight_update_sharding=True)}[what]
        item = "item 11" if what == "fleet_mp" else item
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            lo = fluid.layers.mean(fluid.layers.fc(x, size=1))
        call = lambda: CollectiveOptimizer(  # noqa
            fluid.optimizer.SGDOptimizer(0.1), strategy).minimize(lo)
    elif what == "zero_shard":
        bs = fluid.BuildStrategy()
        bs.zero_shard_optimizer_state = True
        call = lambda: fluid.CompiledProgram(main).with_data_parallel(  # noqa
            loss_name=loss.name, build_strategy=bs)
    elif what == "places":
        item, err = "paddle_tpu_torch.distributed.launch", ValueError
        call = lambda: fluid.CompiledProgram(main).with_data_parallel(  # noqa
            loss_name=loss.name, places=fluid.cpu_places(2))
    else:
        item = "item 13b"
        call = lambda: ps_fleet.distributed_optimizer(  # noqa
            fluid.optimizer.SGDOptimizer(0.1))
    with pytest.raises(err, match=item):
        call()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
