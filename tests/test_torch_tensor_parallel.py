"""Tensor parallelism in the port (``TensorParallelTranspiler``, fleet's
``mp_degree``, ``paddle_tpu_torch/parallel/tensor_parallel.py``,
``fluid/model_parallel.py``) in a world of two ranks against paddle_tpu
at the same degree on its virtual CPU mesh.

One 2-process gloo pack (this file is its worker) runs every port side;
the JAX side runs in this process.  Each program starts from JAX's
startup persistables, carried to both ranks with
``load_numpy_params(..., program=main)``, so each rank keeps its slice of
every sharded weight.

- the Megatron primitives (``column_parallel_matmul``,
  ``row_parallel_matmul``, ``mlp_block``, ``vocab_parallel_embedding``)
  over the two ranks: outputs against JAX's under ``shard_map``, and
  each rank's gradients against the slices of JAX's gradients of the
  unsharded function, within 1e-5;
- per-step losses of 4 steps within 3e-5 (the JAX package's own bound,
  tests/test_bert_acceptance.py:206) for the JAX TP tests' models: the
  Megatron MLP (auto-annotated pair), the same through
  ``with_data_parallel``, the one-layer transformer block with q/k/v
  column-sharded and the output projection row-sharded by
  ``shard_weight`` (the head split through ``reshape2`` sees the
  gathered q/k/v), and tiny BERT through fleet's ``mp_degree=2``;
- each rank holds half of each paired weight and of its momentum, and
  BERT's pairs issue one all-reduce forward and one backward each;
- in this process: the transpiled programs equal JAX's op for op and
  annotation for annotation, the fleet knob and the validation errors
  match, and the (dp, mp) layout of a larger world.

A second pack of four ranks runs the Megatron MLP at mp 2 through
``with_data_parallel``, two dp replicas of two mp ranks, against JAX's
data-parallel run of the same program; then, in the same processes, a
plain data-parallel program, whose ring 0 must still be the world, and
the mp program again with ``zero_shard_optimizer_state`` over the two
replicas, against the same JAX run.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid

from test_torch_collective_ops import pack_logs, start_pack, wait_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

NPROC = 2
NPROC_DP_MP = 4
STEPS = 4
LOSS_TOL = 3e-5
PRIM_TOL = 1e-5
BERT_ROWS, BERT_PRED = 4, 4


# ---------------------------------------------------------------------------
# Shared by the three model-parallel test files
# ---------------------------------------------------------------------------

def persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def build(pkg, make, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = make(pkg)
    return main, startup, loss


def jax_prepare(make, transpile, seed=11, compiled=False):
    """The JAX package's program of ``make`` after ``transpile(jfluid,
    main, startup)``, its startup run: (startup persistables, a function
    running the given feeds and returning the losses)."""
    import paddle_tpu.fluid as jfluid
    main, startup, loss = build(jfluid, make, seed)
    if transpile is not None:
        transpile(jfluid, main, startup)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.find_var(n)) for n in persistables(main)
            if scope.find_var(n) is not None}
    prog = main
    if compiled:
        prog = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)

    def losses(feeds):
        return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss],
                                         scope=scope)[0]).reshape(-1)[0])
                for f in feeds]
    return init, losses


def jax_cases_and_pack(script, out_dir, cases):
    """Every case's JAX startup (its persistables and feeds written to
    ``out_dir`` for the ranks), then the 2-rank pack of ``script``, with
    JAX's steps running while the pack does.  ``cases``: {name: (make,
    transpile, feeds function, compiled)}.  Returns (each rank's JSON,
    {name: JAX's losses})."""
    runs = {}
    for name, (make, transpile, feeds_fn, compiled) in cases.items():
        feeds = feeds_fn()
        init, losses = jax_prepare(make, transpile, compiled=compiled)
        save_case(out_dir, name, (init, feeds))
        runs[name] = (losses, feeds)
    proc = start_pack(script, out_dir)
    try:
        ref = {name: losses(feeds) for name, (losses, feeds) in runs.items()}
    finally:
        done = wait_pack(proc)
    assert done.returncode == 0, done.stderr[-3000:] + pack_logs(out_dir)
    ranks = [json.loads((Path(out_dir) / ("rank%d.json" % r)).read_text())
             for r in range(NPROC)]
    return ranks, ref


def port_run(make, transpile, feeds, init, seed=11, compiled=False):
    """The port's run on this rank: (losses, scope, main)."""
    main, startup, loss = build(fluid, make, seed)
    if transpile is not None:
        transpile(fluid, main, startup)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.load_numpy_params(scope, init, fluid.CPUPlace(), program=main)
    prog = main
    if compiled:
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
    losses = [float(exe.run(prog, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0]) for f in feeds]
    return losses, scope, main


def op_listing(main):
    """(type, inputs, outputs) of every op, for op-for-op comparisons."""
    return [(op.type, sorted((k, list(v)) for k, v in op.inputs.items()),
             sorted((k, list(v)) for k, v in op.outputs.items()))
            for b in main.blocks for op in b.ops]


def save_case(out_dir, name, fn):
    """Write ``{init.npz, feeds.npz}`` of one case into ``out_dir``."""
    init, feeds = fn
    np.savez(Path(out_dir) / ("init_%s.npz" % name), **init)
    np.savez(Path(out_dir) / ("feeds_%s.npz" % name),
             **{"%d/%s" % (i, k): v for i, f in enumerate(feeds)
                for k, v in f.items()})


def load_case(out_dir, name):
    init = dict(np.load(Path(out_dir) / ("init_%s.npz" % name)))
    raw = dict(np.load(Path(out_dir) / ("feeds_%s.npz" % name)))
    feeds = {}
    for key, v in raw.items():
        i, k = key.split("/", 1)
        feeds.setdefault(int(i), {})[k] = v
    return init, [feeds[i] for i in sorted(feeds)]


def bert_feed(rng, cfg, batch, preds):
    """A pretraining batch: true lengths S/2..S, ``preds`` distinct
    masked positions per sequence (flat indices into [B*S])."""
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


def bert_program(cfg, lr=1e-3, strategy=None):
    """Tiny BERT pretraining; ``strategy`` (a DistributedStrategy
    factory taking the package) goes through fleet's optimizer."""
    def b(pkg):
        from importlib import import_module
        base = "paddle_tpu" if pkg.__name__.startswith("paddle_tpu.") \
            else "paddle_tpu_torch"
        bert = import_module(base + ".models.bert")
        opt = pkg.optimizer.AdamOptimizer(learning_rate=lr)
        if strategy is not None:
            coll = import_module(base + ".fluid.incubate.fleet.collective")
            opt = coll.CollectiveOptimizer(opt, strategy(coll))
        return bert.build_pretrain(cfg, max_pred_per_seq=BERT_PRED,
                                   optimizer=opt)["loss"]
    return b


def bert_config():
    from paddle_tpu_torch.models import bert
    return bert.tiny_config(attn_dropout=0.0, hidden_dropout=0.0)


# ---------------------------------------------------------------------------
# Programs, built the same way in both packages
# ---------------------------------------------------------------------------

def megatron_mlp(pkg, hidden=32, ffn=128, classes=8):
    """The JAX TP test's 2-layer Megatron block (fc-col + gelu + fc-row)."""
    x = pkg.layers.data(name="x", shape=[hidden], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    uni = pkg.initializer.Uniform(-0.1, 0.1)
    h = pkg.layers.fc(x, size=ffn, act="gelu",
                      param_attr=pkg.ParamAttr(initializer=uni))
    out = pkg.layers.fc(h, size=hidden,
                        param_attr=pkg.ParamAttr(initializer=uni))
    logits = pkg.layers.fc(x + out, size=classes)
    loss = pkg.layers.mean(
        pkg.layers.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.MomentumOptimizer(learning_rate=0.1,
                                    momentum=0.9).minimize(loss)
    return loss


H_T, HEADS_T, S_T, FFN_T = 32, 4, 8, 64


def transformer_block(pkg):
    """The JAX TP test's one-layer attention block (reshape/slice head
    split of a packed qkv projection)."""
    L = pkg.layers
    H, HEADS, S, FFN = H_T, HEADS_T, S_T, FFN_T
    x = L.data(name="x", shape=[S, H], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    qkv = L.fc(L.reshape(x, [-1, H]), size=3 * H, bias_attr=False)
    qkv = L.reshape(qkv, [-1, S, 3, HEADS, H // HEADS])

    def part(i):
        t = L.transpose(L.slice(qkv, axes=[2], starts=[i], ends=[i + 1]),
                        [0, 3, 1, 2, 4])
        return L.reshape(t, [-1, HEADS, S, H // HEADS])

    q, k, v = part(0), part(1), part(2)
    attn = L.softmax(L.matmul(q, k, transpose_y=True,
                              alpha=(H // HEADS) ** -0.5))
    ctx = L.reshape(L.transpose(L.matmul(attn, v), [0, 2, 1, 3]), [-1, H])
    proj = L.fc(ctx, size=H, bias_attr=False)
    h1 = L.fc(proj, size=FFN, act="gelu", bias_attr=False)
    h2 = L.fc(h1, size=H, bias_attr=False)
    pooled = L.reduce_mean(L.reshape(h2, [-1, S, H]), dim=1)
    logits = L.fc(pooled, size=4)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss


def tp(mp):
    def t(pkg, main, startup):
        pkg.transpiler.TensorParallelTranspiler(mp).transpile(main, startup)
    return t


def tp_manual(pkg, main, startup):
    t = pkg.transpiler.TensorParallelTranspiler(2)
    params = [p.name for p in main.global_block().all_parameters()]
    t.shard_weight(main, [n for n in params if "fc_0" in n][0], dim=1)
    t.shard_weight(main, [n for n in params if "fc_1" in n][0], dim=0)
    t.transpile(main, startup)


def mlp_feeds(seed=7, batch=16):
    rng = np.random.RandomState(seed)
    return [{"x": rng.normal(0, 1, (batch, 32)).astype(np.float32),
             "label": rng.randint(0, 8, (batch, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def block_feeds(seed=9):
    rng = np.random.RandomState(seed)
    return [{"x": rng.normal(0, 1, (8, S_T, H_T)).astype(np.float32),
             "label": rng.randint(0, 4, (8, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def bert_feeds(seed=2):
    cfg = bert_config()
    rng = np.random.RandomState(seed)
    return [bert_feed(rng, cfg, BERT_ROWS, BERT_PRED) for _ in range(STEPS)]


def _mp2(coll):
    return coll.DistributedStrategy(mp_degree=2)


CASES = {    # name: (make, transpile, feeds, through with_data_parallel)
    "mlp": (megatron_mlp, tp(2), mlp_feeds, False),
    "mlp_compiled": (megatron_mlp, tp(2), mlp_feeds, True),
    "block": (transformer_block, tp_manual, block_feeds, False),
    "bert": (bert_program(bert_config(), strategy=_mp2), None, bert_feeds,
             False),
}


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------

PB, PK, PN, PV = 4, 8, 16, 12


def prim_inputs():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(PB, PK).astype(np.float32),
            "w1": rng.randn(PK, PN).astype(np.float32) * 0.3,
            "w2": rng.randn(PN, PK).astype(np.float32) * 0.3,
            "ids": rng.randint(0, PV, (PB, 3)),
            "table": rng.randn(PV, PK).astype(np.float32),
            "g": rng.randn(PB, PK).astype(np.float32)}


def _cot(out, g):
    """The cotangent a primitive's output is multiplied by: ``g`` cut to
    the output's width (broadcast over the lookup's id dim)."""
    g = g[..., :out.shape[-1]]
    return g.unsqueeze(1) if out.dim() == 3 else g


def port_primitives(rank):
    """Outputs and this rank's gradients of the four primitives, each
    rank's loss ``sum(out * cotangent)``."""
    import torch
    from paddle_tpu_torch import parallel
    a = {k: torch.from_numpy(v) for k, v in prim_inputs().items()}
    n1, n2 = PN // NPROC, PV // NPROC
    res = {}

    def run(name, fn, leaves):
        xs = [t.clone().requires_grad_() for t in leaves]
        out = fn(*xs)
        (out * _cot(out, a["g"])).sum().backward()
        res[name] = {"out": out.detach().tolist(),
                     "grads": [x.grad.tolist() for x in xs]}

    w1s = a["w1"][:, rank * n1:(rank + 1) * n1]
    w2s = a["w2"][rank * n1:(rank + 1) * n1]
    run("column", parallel.column_parallel_matmul, [a["x"], w1s])
    run("row", parallel.row_parallel_matmul,
        [(a["x"] @ a["w1"])[:, rank * n1:(rank + 1) * n1], w2s])
    run("mlp", parallel.mlp_block, [a["x"], w1s, w2s])
    run("vocab", lambda t: parallel.vocab_parallel_embedding(a["ids"], t),
        [a["table"][rank * n2:(rank + 1) * n2]])
    return res


def jax_primitives():
    """JAX's outputs (its shard_map primitives over a 2-device 'mp'
    mesh) and gradients (of the unsharded functions, the loss summed
    over the ranks' losses)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.fluid.mesh_utils import shard_map
    from paddle_tpu.parallel import tensor_parallel as jtp
    a = {k: jnp.asarray(v) for k, v in prim_inputs().items()}
    mesh = Mesh(np.array(jax.devices()[:NPROC]), ("mp",))

    def smap(fn, args, specs, out_spec):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=mesh, in_specs=specs, out_specs=out_spec,
            check_vma=False))(*args))

    h = a["x"] @ a["w1"]
    g = a["g"]
    out = {
        "column": smap(jtp.column_parallel_matmul, (a["x"], a["w1"]),
                       (P(), P(None, "mp")), P(None, "mp")),
        "row": smap(lambda hh, w: jtp.row_parallel_matmul(hh, w),
                    (h, a["w2"]), (P(None, "mp"), P("mp", None)), P()),
        "mlp": smap(lambda x, w1, w2: jtp.mlp_block(x, w1, w2),
                    (a["x"], a["w1"], a["w2"]),
                    (P(), P(None, "mp"), P("mp", None)), P()),
        "vocab": smap(lambda i, t: jtp.vocab_parallel_embedding(i, t),
                      (a["ids"], a["table"]), (P(), P("mp", None)), P()),
    }
    # column: rank r's loss is sum(out_r * g[:, :N/2]), out_r its slice
    gcol = jnp.concatenate([g[:, :PN // NPROC]] * NPROC, axis=1)
    grads = {
        "column": jax.grad(lambda x, w: jnp.sum((x @ w) * gcol),
                           (0, 1))(a["x"], a["w1"]),
        "row": jax.grad(lambda hh, w: jnp.sum((hh @ w) * g), (0, 1))(
            h, a["w2"]),
        "mlp": jax.grad(
            lambda x, w1, w2: jnp.sum((jax.nn.relu(x @ w1) @ w2) * g),
            (0, 1, 2))(a["x"], a["w1"], a["w2"]),
        "vocab": jax.grad(lambda t: jnp.sum(t[a["ids"]] * g[:, None, :]),
                          (0,))(a["table"]),
    }
    return out, grads


# ---------------------------------------------------------------------------
# The pack
# ---------------------------------------------------------------------------

def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist
    from paddle_tpu_torch.parallel import tensor_parallel as ptp
    torch.set_num_threads(1)
    rank, n = dist.init(place=fluid.CPUPlace())
    res = {"rank": rank, "world": n, "losses": {}, "comm": {},
           "shapes": {}, "errors": {}}
    res["prims"] = port_primitives(rank)
    for name, (make, transpile, _f, compiled) in CASES.items():
        init, feeds = load_case(out_dir, name)
        ptp.reset_comm()
        losses, scope, main = port_run(make, transpile, feeds, init,
                                       compiled=compiled)
        res["losses"][name] = losses
        res["comm"][name] = {"%s@%s" % k: list(v)
                             for k, v in ptp.comm.items()}
        res["shapes"][name] = {
            nm: list(scope.find_var(nm).shape) for nm in persistables(main)
            if scope.find_var(nm) is not None and
            hasattr(scope.find_var(nm), "shape")}
        res["ann_%s" % name] = {k: list(v) for k, v in
                                main._mp_shardings.items()}
    # a degree the world does not divide
    from paddle_tpu_torch.fluid.incubate.fleet.collective import (
        CollectiveOptimizer, DistributedStrategy)
    try:
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data(name="x", shape=[6], dtype="float32")
            lo = fluid.layers.mean(fluid.layers.fc(
                fluid.layers.fc(x, size=6, act="relu"), size=6))
            CollectiveOptimizer(fluid.optimizer.SGDOptimizer(0.1),
                                DistributedStrategy(mp_degree=3)).minimize(lo)
        res["errors"]["indivisible"] = None
    except ValueError as e:
        res["errors"]["indivisible"] = str(e)
    # dropout inside a pair draws a rank-local mask; outside, the same
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(x, size=64)
        hd = fluid.layers.dropout(h, 0.5)
        o = fluid.layers.fc(hd, size=16)
        od = fluid.layers.dropout(o, 0.5)
        fluid.optimizer.SGDOptimizer(0.1).minimize(fluid.layers.mean(od))
    fluid.transpiler.TensorParallelTranspiler(2).transpile(main, startup)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    m_in, m_out = exe.run(main, feed={"x": np.ones((4, 16), np.float32)},
                          fetch_list=[hd, od], scope=scope)
    res["mask_in_pair"] = (m_in != 0).astype(int).tolist()
    res["mask_after_pair"] = (m_out != 0).astype(int).tolist()
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


def worker_dp_mp(out_dir):
    """A rank of the world of four: the Megatron MLP at mp 2 through
    ``with_data_parallel`` (replica ``rank // 2`` fed its half of each
    batch), then the plain MLP through ``with_data_parallel`` (each rank
    fed its quarter) and the plain MLP in this process on the whole
    batch, the reference of the data-parallel run."""
    import torch
    from paddle_tpu_torch.fluid import distributed as dist
    torch.set_num_threads(1)
    rank, n = dist.init(place=fluid.CPUPlace())
    init, feeds = load_case(out_dir, "dp_mp")

    def rows(f, i, parts):
        m = len(f["x"]) // parts
        return {k: v[i * m:(i + 1) * m] for k, v in f.items()}

    res = {"rank": rank, "world": n}
    res["mp_losses"], _scope, _main = port_run(
        megatron_mlp, tp(2), [rows(f, rank // 2, 2) for f in feeds], init,
        compiled=True)
    _l, dp_scope, main = port_run(
        megatron_mlp, None, [rows(f, rank, n) for f in feeds], init,
        compiled=True)
    _l, one_scope, _m = port_run(megatron_mlp, None, feeds, init)
    res["dp_param_err"] = max(
        float(np.abs(np.asarray(dp_scope.find_var(p.name)) -
                     np.asarray(one_scope.find_var(p.name))).max())
        for p in main.global_block().all_parameters())
    # weight-update sharding over the two replicas: each rank holds 1/2
    # of the Momentum state of its mp shard
    main, startup, loss = build(fluid, megatron_mlp)
    tp(2)(fluid, main, startup)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.load_numpy_params(scope, init, fluid.CPUPlace(), program=main)
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=zero_strategy(fluid))
    res["zero_losses"] = [
        float(exe.run(prog, feed=rows(f, rank // 2, 2), fetch_list=[loss],
                      scope=scope)[0].reshape(-1)[0]) for f in feeds]
    res["zero_state"] = {n: list(scope.find_var(n).shape)
                         for n in scope.var_names()
                         if n.startswith("wus_") or "velocity" in n}
    res["params"] = {n: list(scope.find_var(n).shape)
                     for n in ("fc_0.w_0", "fc_1.w_0", "fc_2.w_0")}
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


def zero_strategy(pkg):
    bs = pkg.BuildStrategy()
    bs.zero_shard_optimizer_state = True
    return bs


@pytest.fixture(scope="module")
def pack_dp_mp(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("tp_dp_mp_pack")
    feeds = mlp_feeds()
    init, losses = jax_prepare(megatron_mlp, tp(2), compiled=True)
    save_case(out_dir, "dp_mp", (init, feeds))
    proc = start_pack(Path(__file__), out_dir, nproc=NPROC_DP_MP,
                      args=("dp_mp",))
    try:
        ref = losses(feeds)
    finally:
        done = wait_pack(proc)
    assert done.returncode == 0, \
        done.stderr[-3000:] + pack_logs(out_dir, NPROC_DP_MP)
    ranks = [json.loads((out_dir / ("rank%d.json" % r)).read_text())
             for r in range(NPROC_DP_MP)]
    return ranks, ref


def test_tp_by_dp_losses_match_jax(pack_dp_mp):
    """Two dp replicas of two mp ranks: both ranks of a replica see the
    same loss, and the replicas' mean (their halves are equal in size)
    is JAX's loss of the whole batch, step after step, so the gradients
    were averaged over the two replicas."""
    ranks, ref = pack_dp_mp
    assert [r["world"] for r in ranks] == [NPROC_DP_MP] * NPROC_DP_MP
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_allclose(ranks[a]["mp_losses"],
                                   ranks[b]["mp_losses"], rtol=1e-6,
                                   atol=1e-6)
    mean = (np.asarray(ranks[0]["mp_losses"]) +
            np.asarray(ranks[2]["mp_losses"])) / 2
    np.testing.assert_allclose(mean, ref, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert len(set(np.round(ranks[0]["mp_losses"], 6))) == STEPS


def test_plain_data_parallel_after_a_tp_run_spans_the_world(pack_dp_mp):
    """A plain data-parallel program run after the model-parallel one in
    the same processes averages over all four ranks: its parameters
    after every step equal the one-process run on the whole batch.  Had
    the dp group of the mp run become ring 0 for the process, each pair
    of ranks would average only its own two quarters."""
    ranks, _ = pack_dp_mp
    for r in ranks:
        assert r["dp_param_err"] <= PRIM_TOL, r


def test_weight_update_sharding_of_tp_replicas_matches_jax(pack_dp_mp):
    """``zero_shard_optimizer_state`` over the two dp replicas of the mp
    program: the replicas' mean loss is JAX's data-parallel run's, step
    after step (the sharded update equals the replicated one; JAX's own
    run with the option raises a sharding mismatch on its dp 4 x mp 2
    mesh); each rank holds half of the Momentum state of its mp shard of
    each weight (the per-parameter velocities are gone), and its shard
    of each paired weight."""
    ranks, zero = pack_dp_mp
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_allclose(ranks[a]["zero_losses"],
                                   ranks[b]["zero_losses"], rtol=1e-6,
                                   atol=1e-6)
    mean = (np.asarray(ranks[0]["zero_losses"]) +
            np.asarray(ranks[2]["zero_losses"])) / 2
    np.testing.assert_allclose(mean, zero, rtol=LOSS_TOL, atol=LOSS_TOL)
    # fc_0.w_0 [32, 128] column-sharded, fc_1.w_0 [128, 32] row-sharded:
    # 2048 elements a rank each, 1024 of its velocity a replica
    for r in ranks:
        assert r["params"] == {"fc_0.w_0": [32, 64], "fc_1.w_0": [64, 32],
                               "fc_2.w_0": [32, 8]}
        assert not [n for n in r["zero_state"] if not n.startswith("wus_")]
        sizes = sorted(int(np.prod(s)) for s in r["zero_state"].values())
        assert 1024 in sizes and max(sizes) == 1024, r["zero_state"]


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    return jax_cases_and_pack(Path(__file__),
                              tmp_path_factory.mktemp("tp_pack"), CASES)


def test_pack_ran_two_gloo_ranks(pack):
    ranks, _ = pack
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == NPROC for r in ranks)


@pytest.mark.parametrize("name", ["column", "row", "mlp", "vocab"])
def test_primitive_matches_jax(pack, name):
    ranks, _ = pack
    out, grads = jax_primitives()
    n1 = PN // NPROC
    for r in ranks:
        got = r["prims"][name]
        want = np.asarray(out[name])
        if name == "column":
            want = want[:, r["rank"] * n1:(r["rank"] + 1) * n1]
        np.testing.assert_allclose(got["out"], want, rtol=PRIM_TOL,
                                   atol=PRIM_TOL)
        rk = r["rank"]
        g = [np.asarray(t) for t in grads[name]]
        cut = {"column": [None, (1, n1)], "row": [(1, n1), (0, n1)],
               "mlp": [None, (1, n1), (0, n1)],
               "vocab": [(0, PV // NPROC)]}[name]
        want_g = [t if c is None else
                  np.take(t, range(rk * c[1], (rk + 1) * c[1]), axis=c[0])
                  for t, c in zip(g, cut)]
        for got_g, w in zip(got["grads"], want_g):
            np.testing.assert_allclose(got_g, w, rtol=PRIM_TOL,
                                       atol=PRIM_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax_at_mp2(pack, name):
    ranks, ref = pack
    for r in ranks:
        np.testing.assert_allclose(r["losses"][name], ref[name],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    assert np.all(np.isfinite(ref[name]))


def test_each_rank_holds_half_of_each_paired_weight(pack):
    ranks, _ = pack
    for r in ranks:
        shapes, ann = r["shapes"]["mlp"], r["ann_mlp"]
        assert ann == {"fc_0.w_0": ["mp", 1], "fc_1.w_0": ["mp", 0],
                       "fc_0.b_0": ["mp", 0]}
        assert shapes["fc_0.w_0"] == [32, 64]
        assert shapes["fc_1.w_0"] == [64, 32]
        assert shapes["fc_0.b_0"] == [64]
        assert shapes["fc_2.w_0"] == [32, 8]          # not in a pair
        vel = [n for n in shapes if n.startswith("fc_0.w_0_velocity")]
        assert vel and shapes[vel[0]] == [32, 64]


def test_bert_pairs_cost_one_allreduce_each_way(pack):
    """tiny BERT has three Megatron pairs (two FFNs, pooler + NSP head):
    three all-reduces forward and three backward a step."""
    ranks, _ = pack
    for r in ranks:
        calls, nbytes = r["comm"]["bert"]["allreduce@mp"]
        assert calls == 6 * STEPS
        assert nbytes > 0
        assert set(r["comm"]["bert"]) == {"allreduce@mp"}


def test_manual_shard_weight_is_gathered_before_the_head_split(pack):
    ranks, _ = pack
    for r in ranks:
        shapes = r["shapes"]["block"]
        assert shapes["fc_0.w_0"] == [H_T, 3 * H_T // 2]
        assert shapes["fc_1.w_0"] == [H_T // 2, H_T]
        calls = dict(r["comm"]["block"])
        assert "allgather@mp" in calls


def test_dropout_mask_is_rank_local_only_inside_a_pair(pack):
    """Inside the pair each rank draws the mask of its feature shard with
    its rank folded in (the fetch gathers the two halves); after the row
    all-reduce both ranks draw the same mask, as the activation is the
    same on both."""
    ranks, _ = pack
    assert ranks[0]["mask_after_pair"] == ranks[1]["mask_after_pair"]
    m = np.asarray(ranks[0]["mask_in_pair"])
    assert m.shape == (4, 64)
    assert (m[:, :32] != m[:, 32:]).any()
    assert ranks[0]["mask_in_pair"] == ranks[1]["mask_in_pair"]


def test_indivisible_world_is_refused(pack):
    ranks, _ = pack
    for r in ranks:
        assert "does not divide the world of 2" in r["errors"]["indivisible"]


@pytest.mark.parametrize("name", ["mlp", "block", "bert"])
def test_transpiled_program_matches_jax_op_for_op(name):
    import paddle_tpu.fluid as jfluid
    make, transpile, _f, _c = CASES[name]
    progs = {}
    for pkg in (jfluid, fluid):
        main, startup, _loss = build(pkg, make)
        if transpile is not None:
            transpile(pkg, main, startup)
        progs[pkg.__name__] = main
    jm, pm = progs["paddle_tpu.fluid"], progs["paddle_tpu_torch.fluid"]
    assert op_listing(pm) == op_listing(jm)
    assert pm._mp_shardings == jm._mp_shardings
    assert pm._mp_degree == jm._mp_degree == 2


def test_fleet_knob_and_validation_match_jax():
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.incubate.fleet import collective as jcoll
    from paddle_tpu_torch.fluid.incubate.fleet import collective as pcoll
    for pkg, coll in ((jfluid, jcoll), (fluid, pcoll)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[32], dtype="float32")
            h = pkg.layers.fc(x, size=64, act="relu")
            loss = pkg.layers.mean(pkg.layers.fc(h, size=8))
            coll.CollectiveOptimizer(
                pkg.optimizer.SGDOptimizer(0.1),
                coll.DistributedStrategy(mp_degree=4)).minimize(
                    loss, startup_program=startup)
        assert main._mp_degree == 4 and main._mp_shardings
        assert not getattr(main, "_use_collective", False)
        with pytest.raises(ValueError, match="local_sgd"):
            with pkg.program_guard(pkg.Program(), pkg.Program()):
                x = pkg.layers.data(name="x", shape=[8], dtype="float32")
                lo = pkg.layers.mean(pkg.layers.fc(x, size=8))
                coll.CollectiveOptimizer(
                    pkg.optimizer.SGDOptimizer(0.1),
                    coll.DistributedStrategy(mp_degree=2, local_sgd=True)
                ).minimize(lo)
        t = pkg.transpiler.TensorParallelTranspiler(3)
        w = main.global_block().all_parameters()[0]
        with pytest.raises(ValueError):
            t.shard_weight(main, w.name, dim=5)
        with pytest.raises(ValueError):
            t.shard_weight(main, "nonexistent_w", dim=0)
        with pytest.raises(ValueError, match="no Megatron"):
            empty = pkg.Program()
            with pkg.program_guard(empty, pkg.Program()):
                x = pkg.layers.data(name="x", shape=[8], dtype="float32")
                pkg.layers.mean(x)
            pkg.transpiler.TensorParallelTranspiler(2).transpile(empty)


def test_fc_parallel_layers_and_head_split_match_jax():
    """The annotation-only layer functions mark the same weights as the
    JAX package's, and the head split reshapes the same way."""
    import jax.numpy as jnp
    import paddle_tpu.fluid as jfluid
    import torch
    from paddle_tpu.parallel import tensor_parallel as jtp
    from paddle_tpu_torch.parallel import tensor_parallel as ptp
    marks = []
    for pkg, mod in ((jfluid, jtp), (fluid, ptp)):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()), \
                pkg.unique_name.guard():
            x = pkg.layers.data(name="x", shape=[8], dtype="float32")
            h = mod.fc_column_parallel(x, 16, act="relu")
            mod.fc_row_parallel(h, 8)
        marks.append(([p.mesh_sharding for p in
                       main.global_block().all_parameters()],
                      op_listing(main)))
    assert marks[0] == marks[1]
    qkv = np.random.RandomState(0).randn(2, 3, 8).astype(np.float32)
    np.testing.assert_array_equal(
        ptp.attention_heads_split(torch.from_numpy(qkv), 4, 2).numpy(),
        np.asarray(jtp.attention_heads_split(jnp.asarray(qkv), 4,
                                             axis_size=2)))


def test_dp_by_mp_layout_of_a_larger_world():
    from paddle_tpu_torch.fluid import mesh_utils, model_parallel
    main, _startup, _loss = build(fluid, megatron_mlp)
    tp(2)(fluid, main, _startup)
    layout = model_parallel.layout(main, 8)
    assert layout == [("dp", 4), ("mp", 2)]
    c = mesh_utils.Coords("mp", layout, 5)
    assert (c.rank, c.dp_rank, c.dp_size) == (1, 2, 4)
    assert c.group_ranks == [4, 5] and c.dp_ranks == [1, 3, 5, 7]
    main._mp_degree, main._sp_degree = 1, 3
    with pytest.raises(ValueError, match="does not divide"):
        model_parallel.layout(main, 8)


def test_sharded_weights_load_unsharded_without_a_world():
    """No process group: the degrees are ignored and the global arrays
    load as they are (the JAX package runs unsharded off the mesh)."""
    main, startup, _loss = build(fluid, megatron_mlp)
    tp(2)(fluid, main, startup)
    scope = fluid.Scope()
    arr = np.zeros((32, 128), np.float32)
    fluid.load_numpy_params(scope, {"fc_0.w_0": arr}, fluid.CPUPlace(),
                            program=main)
    assert tuple(scope.find_var("fc_0.w_0").shape) == (32, 128)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    if sys.argv[3:4] == ["dp_mp"]:
        worker_dp_mp(sys.argv[2])
    else:
        worker(sys.argv[2])
