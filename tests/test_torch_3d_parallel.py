"""The compositions in the port: pipelines with dp, mp, sp and ep
(``fluid/pipeline.py``), and dp x mp x sp x ep without a pipeline
(``fluid/model_parallel.py``'s per-axis layout and plan), in a world of
eight ranks against paddle_tpu on its eight-device virtual CPU mesh.

One 8-process gloo pack (this file is its worker) runs every port side;
the JAX side runs in this process while the ranks run.  Each program
starts from JAX's startup persistables, carried to every rank with
``load_numpy_params(..., program=main)``, so each rank keeps its slice of
every model-parallel weight.  The cases are those of
tests/test_3d_parallel.py, tests/test_moe_transformer_composition.py and
tests/test_expert_parallel.py:214,394, each held to JAX's per-step losses
at JAX's own tolerance (5e-5; the MoE compositions' 3e-5):

- dp2 x mp2 x pp2 and dp4 x pp2 (the Megatron fc pairs in two stages);
- the at-width memory fractions: under dp2 x mp2 x pp2 with Momentum a
  paired weight and its velocity are held at 1/mp, a stage parameter
  and its velocity at 1/pp, and the stored total is at most 0.62 of the
  whole;
- pp2 x sp2 (dp 2) and pp2 x mp2 x sp2 (the attention blocks in two
  stages), and both island refusals with JAX's message;
- pp2 x ep4 with the dense dispatch (each rank holds 1/4 of the
  experts), and the a2a dispatch under a pipeline refused;
- tiny BERT at mp2 x sp2 (Ulysses) and in two stages at mp 2;
- the MoE transformer at sp2 x ep2 x dp2 and sp2 x ep2 with the a2a
  dispatch (through ``with_data_parallel``), sp4 x ep2; the
  Megatron-attention model at mp2 x sp2 x dp2; SP and EP alone with
  dp 4; and the same mp2 x sp2 program through fleet's
  ``DistributedStrategy`` in a world of eight, whose dp route
  all-reduces the gradients over the two replicas.

A replica fed its 1/dp of the batch reports its own mean loss; the mean
over the replicas is JAX's loss of the whole batch.  A pipelined run is
fed the whole batch on every rank and reports the whole batch's loss.
"""

import contextlib
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid

from test_torch_collective_ops import pack_logs, start_pack, wait_pack
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_pipeline import (M2, RTOL, bert_two_stages, publish_case,
                                 rebase_mask_pos, wait_case)
from test_torch_tensor_parallel import (LOSS_TOL, bert_config, bert_feeds,
                                        bert_program, build, jax_prepare,
                                        persistables, port_run)

NPROC = 8
PIPE_TOL = 5e-5                # tests/test_3d_parallel.py
MOE_TOL = 3e-5                 # tests/test_moe_transformer_composition.py

# tests/test_3d_parallel.py
B3, D3, F3, M3 = 8, 16, 32, 2
SQ, HH, DH = 16, 2, 8
DMH = HH * DH
# tests/test_moe_transformer_composition.py
BM, SM, HM, DM_ = 8, 16, 4, 8
DMM = HM * DM_
EM, FM = 4, 32


# ---------------------------------------------------------------------------
# Programs, built the same way in both packages
# ---------------------------------------------------------------------------

def _stage(pkg, pipeline, k):
    return pkg.device_guard("pp:%d" % k) if pipeline \
        else contextlib.nullcontext()


def _opt(pkg, pipeline, inner):
    return pkg.optimizer.PipelineOptimizer(inner, num_microbatches=M3) \
        if pipeline else inner


def pairs_model(pipeline=True):
    """tests/test_3d_parallel.py::_model: two Megatron fc pairs split
    across two stages, SGD 0.1."""
    def b(pkg):
        L = pkg.layers
        uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.2, 0.2))

        def pair(h):
            h1 = L.fc(h, size=F3, act="gelu", param_attr=uni)
            return L.fc(h1, size=D3, param_attr=uni)

        with _stage(pkg, pipeline, 0):
            x = L.data(name="x", shape=[B3, D3], dtype="float32",
                       append_batch_size=False)
            h = x + pair(x)
        with _stage(pkg, pipeline, 1):
            y = L.data(name="y", shape=[B3, 1], dtype="float32",
                       append_batch_size=False)
            h = h + pair(h)
            pred = L.fc(h, size=1, param_attr=uni)
            loss = L.reduce_mean(L.square_error_cost(pred, y))
        _opt(pkg, pipeline, pkg.optimizer.SGDOptimizer(0.1)).minimize(loss)
        return loss
    return b


DW, FW = 64, 128


def wide_model(pkg):
    """tests/test_3d_parallel.py::test_3d_at_width_memory_fractions."""
    L = pkg.layers
    uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.1, 0.1))
    with pkg.device_guard("pp:0"):
        x = L.data(name="x", shape=[B3, DW], dtype="float32",
                   append_batch_size=False)
        h1 = L.fc(x, size=FW, act="gelu", param_attr=uni)
        h = x + L.fc(h1, size=DW, param_attr=uni)
    with pkg.device_guard("pp:1"):
        y = L.data(name="y", shape=[B3, 1], dtype="float32",
                   append_batch_size=False)
        h2 = L.fc(h, size=FW, act="gelu", param_attr=uni)
        h = h + L.fc(h2, size=DW, param_attr=uni)
        pred = L.fc(h, size=1, param_attr=uni)
        loss = L.reduce_mean(L.square_error_cost(pred, y))
    pkg.optimizer.PipelineOptimizer(
        pkg.optimizer.MomentumOptimizer(0.05, momentum=0.9),
        num_microbatches=M3).minimize(loss)
    return loss


def attn_stages_model(megatron=False, asym=False, dropouts=(0.0, 0.0)):
    """The attention blocks of tests/test_3d_parallel.py in two stages:
    pp2 x sp2 (``megatron`` adds the column-row pair of pp2 x mp2 x sp2);
    ``asym`` drops stage 1's attention, ``dropouts`` sets each stage's
    attention dropout (the two refusal programs)."""
    def b(pkg):
        L = pkg.layers
        uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.1, 0.1))

        def attn_block(h, dropout):
            def heads(t):
                return L.transpose(L.reshape(t, [0, SQ, HH, DH]),
                                   [0, 2, 1, 3])
            q = heads(L.fc(h, size=DMH, num_flatten_dims=2, param_attr=uni))
            ctx = L.fused_attention(q, q, q, scale=DH ** -0.5,
                                    dropout_prob=dropout)
            ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, SQ, DMH])
            if not megatron:
                return h + ctx
            f1 = L.fc(h + ctx, size=2 * DMH, num_flatten_dims=2, act="gelu",
                      param_attr=uni)
            return h + L.fc(f1, size=DMH, num_flatten_dims=2,
                            param_attr=uni)

        with pkg.device_guard("pp:0"):
            x = L.data(name="x", shape=[8, SQ, DMH], dtype="float32",
                       append_batch_size=False)
            h = attn_block(x, dropouts[0])
        with pkg.device_guard("pp:1"):
            y = L.data(name="y", shape=[8, 1], dtype="float32",
                       append_batch_size=False)
            if not asym:
                h = attn_block(h, dropouts[1])
            pred = L.fc(L.reduce_mean(h, dim=1), size=1, param_attr=uni)
            loss = L.reduce_mean(L.square_error_cost(pred, y))
        pkg.optimizer.PipelineOptimizer(
            pkg.optimizer.SGDOptimizer(0.1),
            num_microbatches=M3).minimize(loss)
        return loss
    return b


def pp_moe_model(dispatch_two=False):
    """tests/test_expert_parallel.py:214 (a switch_moe in stage 0) and,
    with ``dispatch_two``, :394 (one in each stage)."""
    def b(pkg):
        L = pkg.layers
        with pkg.device_guard("pp:0"):
            x = L.data(name="x", shape=[8, 4, 16], dtype="float32",
                       append_batch_size=False)
            moe0, aux0 = L.switch_moe(x, num_experts=4, ffn_dim=8,
                                      capacity_factor=8.0)
            h = x + moe0 if dispatch_two else \
                L.fc(L.reduce_mean(x + moe0, dim=1), size=8)
        with pkg.device_guard("pp:1"):
            y = L.data(name="y", shape=[8, 1], dtype="float32",
                       append_batch_size=False)
            if dispatch_two:
                moe1, aux1 = L.switch_moe(h, num_experts=4, ffn_dim=8,
                                          capacity_factor=8.0)
                pred = L.fc(L.reduce_mean(h + moe1, dim=1), size=1)
                loss = L.reduce_mean(L.square_error_cost(pred, y)) \
                    + 0.01 * L.reduce_sum(aux0) + 0.01 * L.reduce_sum(aux1)
            else:
                pred = L.fc(h, size=1)
                loss = L.reduce_mean(L.square_error_cost(pred, y))
        pkg.optimizer.PipelineOptimizer(
            pkg.optimizer.SGDOptimizer(0.1),
            num_microbatches=2).minimize(loss)
        return loss
    return b


def moe_transformer(cf=1.25):
    """tests/test_moe_transformer_composition.py::_moe_transformer."""
    def b(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[SM, DMM], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.1, 0.1))
        q = L.transpose(L.reshape(L.fc(x, size=DMM, num_flatten_dims=2,
                                       param_attr=uni), [0, SM, HM, DM_]),
                        [0, 2, 1, 3])
        ctx = L.fused_attention(q, q, q, scale=DM_ ** -0.5)
        h = x + L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, SM, DMM])
        moe_out, aux = L.switch_moe(h, num_experts=EM, ffn_dim=FM,
                                    act="gelu", param_attr=uni,
                                    capacity_factor=cf)
        h = h + moe_out
        logits = L.fc(L.reduce_mean(h, dim=1), size=8, param_attr=uni)
        ce = L.mean(L.softmax_with_cross_entropy(logits, label))
        loss = ce + 0.01 * L.reduce_sum(aux)
        pkg.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
        return loss
    return b


def megatron_attn_model(strategy=None):
    """tests/test_moe_transformer_composition.py::test_loss_parity_
    mp2_sp2_dp2's model; ``strategy`` (a DistributedStrategy factory
    taking the fleet collective module) goes through fleet's
    optimizer."""
    def b(pkg):
        from importlib import import_module
        L = pkg.layers
        x = L.data(name="x", shape=[SM, DMM], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.1, 0.1))
        q = L.transpose(L.reshape(L.fc(x, size=DMM, num_flatten_dims=2,
                                       param_attr=uni), [0, SM, HM, DM_]),
                        [0, 2, 1, 3])
        ctx = L.fused_attention(q, q, q, scale=DM_ ** -0.5)
        h = x + L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, SM, DMM])
        pooled = L.reduce_mean(h, dim=1)
        f = L.fc(pooled, size=64, act="gelu", param_attr=uni)
        f2 = L.fc(f, size=DMM, param_attr=uni)
        logits = L.fc(pooled + f2, size=8, param_attr=uni)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        opt = pkg.optimizer.MomentumOptimizer(0.05, 0.9)
        if strategy is not None:
            base = pkg.__name__.rsplit(".", 1)[0]
            coll = import_module(base + ".fluid.incubate.fleet.collective")
            opt = coll.CollectiveOptimizer(opt, strategy(coll))
        opt.minimize(loss)
        return loss
    return b


def degrees(tp=0, sp=0, ep=0, dispatch="dense", ep_first=False,
            mode="ring"):
    """The transpiles of a composition, in the JAX tests' order: tp, then
    sp (``mode``), then ep (``ep_first``: ep before sp)."""
    def t(pkg, main, startup):
        T = pkg.transpiler
        steps = [("tp", tp), ("ep", ep), ("sp", sp)] if ep_first else \
            [("tp", tp), ("sp", sp), ("ep", ep)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for kind, d in steps:
                if not d:
                    continue
                if kind == "tp":
                    T.TensorParallelTranspiler(d).transpile(main, startup)
                elif kind == "sp":
                    T.SequenceParallelTranspiler(d, mode=mode).transpile(
                        main, startup)
                else:
                    T.ExpertParallelTranspiler(
                        d, dispatch=dispatch).transpile(main, startup)
    return t


def _feeds(shapes, seed, steps=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        f = {}
        for name, (shape, kind) in shapes.items():
            f[name] = rng.normal(0, 1, shape).astype(np.float32) \
                if kind == "f" else rng.randint(0, 8, shape).astype(np.int64)
        out.append(f)
    return out


def pairs_feeds():
    return _feeds({"x": ((B3, D3), "f"), "y": ((B3, 1), "f")}, 21)


def wide_feeds():
    return _feeds({"x": ((B3, DW), "f"), "y": ((B3, 1), "f")}, 3, steps=2)


def attn_feeds():
    return _feeds({"x": ((8, SQ, DMH), "f"), "y": ((8, 1), "f")}, 51)


def pp_moe_feeds():
    return _feeds({"x": ((8, 4, 16), "f"), "y": ((8, 1), "f")}, 0, steps=3)


def moe_feeds(seed=33):
    return _feeds({"x": ((BM, SM, DMM), "f"), "label": ((BM, 1), "i")},
                  seed)


def _mp2_sp2(coll):
    return coll.DistributedStrategy(mp_degree=2, sp_degree=2)


# name: (make, transpile, feeds, through with_data_parallel, the world's
# dp replicas a rank's feed is cut for (1: the whole batch), tolerance)
CASES = {
    "dp2_mp2_pp2": (pairs_model(), degrees(tp=2), pairs_feeds, False, 1,
                    PIPE_TOL),
    "dp4_pp2": (pairs_model(), None, pairs_feeds, False, 1, PIPE_TOL),
    "at_width": (wide_model, degrees(tp=2), wide_feeds, False, 1,
                 PIPE_TOL),
    "pp2_sp2": (attn_stages_model(), degrees(sp=2), attn_feeds, False, 1,
                PIPE_TOL),
    "pp2_mp2_sp2": (attn_stages_model(megatron=True),
                    degrees(tp=2, sp=2), attn_feeds, False, 1, PIPE_TOL),
    "pp2_ep4": (pp_moe_model(), degrees(ep=4), pp_moe_feeds, False, 1,
                MOE_TOL),
    "sp2_ep2_dp2": (moe_transformer(), degrees(sp=2, ep=2), moe_feeds,
                    True, 2, MOE_TOL),
    "sp4_ep2": (moe_transformer(), degrees(sp=4, ep=2), moe_feeds, False,
                1, MOE_TOL),
    "mp2_sp2_dp2": (megatron_attn_model(), degrees(tp=2, sp=2),
                    lambda: moe_feeds(41), True, 2, MOE_TOL),
    "sp2_ep2_a2a_dp2": (moe_transformer(cf=8.0),
                        degrees(sp=2, ep=2, dispatch="a2a", ep_first=True),
                        moe_feeds,
                        True, 2, MOE_TOL),
    "sp2_dp4": (moe_transformer(), degrees(sp=2), moe_feeds, True, 4,
                MOE_TOL),
    "ep2_dp4": (moe_transformer(), degrees(ep=2), moe_feeds, True, 4,
                MOE_TOL),
    # tiny BERT on the chip's two composed paths: at mp2 x sp2 Ulysses
    # (dp 2, the replicas fed alike) and in two stages at mp 2 (dp 2)
    "bert_mp2_sp2": (bert_program(bert_config()),
                     degrees(tp=2, sp=2, mode="ulysses"), bert_feeds, False,
                     1, LOSS_TOL),
}
# tiny BERT in two stages at mp 2: (name, make, transpile, JAX's twin
# case, tolerance).  From the twin's startup (the parameters carry the
# same names) on its batches, against its losses.  The world's dp 2
# divides the batch of 4 into dp x M microbatches of one sequence each,
# so mask_pos is re-based to each sequence.
PP_BERT = ("bert_pp2_mp2", bert_two_stages(), degrees(tp=2), "bert_mp2_sp2",
           RTOL)
PP_BERT_MICRO = 2 * M2
# the fleet route is held to the JAX run of its twin
FLEET = ("fleet_mp2_sp2_dp2", megatron_attn_model(_mp2_sp2), "mp2_sp2_dp2",
         2)
REFUSED = {     # name: (make, transpile, the JAX package's message)
    "asymmetric_islands": (attn_stages_model(asym=True), degrees(sp=2),
                           "SAME sequence of collective"),
    "island_routing": (attn_stages_model(dropouts=(0.0, 0.3)),
                       degrees(sp=2), "SAME sequence of collective"),
    "a2a_under_pipeline": (pp_moe_model(dispatch_two=True),
                           degrees(ep=4, dispatch="a2a"),
                           "does not compose with the pipeline"),
}


def _rows(feed, i, parts):
    """Replica ``i``'s 1/parts of each feed's rows."""
    return {k: np.split(v, parts)[i] for k, v in feed.items()}


# ---------------------------------------------------------------------------
# The pack
# ---------------------------------------------------------------------------

def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist
    from paddle_tpu_torch.parallel import tensor_parallel as ptp
    torch.set_num_threads(1)
    rank, n = dist.init(place=fluid.CPUPlace())
    res = {"rank": rank, "world": n, "losses": {}, "shapes": {},
           "errors": {}, "comm": {}}
    warnings.simplefilter("ignore")

    def run(name, make, transpile, compiled, replicas):
        init, feeds = wait_case(out_dir, name)
        feeds = [_rows(f, rank // (n // replicas), replicas) for f in feeds]
        ptp.reset_comm()
        losses, scope, main = port_run(make, transpile, feeds, init,
                                       compiled=compiled)
        res["comm"][name] = sorted("%s@%s" % k for k in ptp.comm)
        res["losses"][name] = losses
        res["shapes"][name] = {
            nm: list(scope.find_var(nm).shape) for nm in persistables(main)
            if scope.find_var(nm) is not None and
            hasattr(scope.find_var(nm), "shape")}
        return main

    for name, (make, transpile, _f, compiled, replicas, _t) in CASES.items():
        main = run(name, make, transpile, compiled, replicas)
        if name == "at_width":
            res["annotated"] = sorted(main._mp_shardings)
            res["links"] = dict(main._opt_state_of)
    name, make, twin, replicas = FLEET
    main = run(name, make, None, False, replicas)
    res["fleet_ops"] = [op.type for op in main.global_block().ops]
    name, make, transpile, _twin, _tol = PP_BERT
    run(name, make, transpile, False, 1)
    for name, (make, transpile, _msg) in REFUSED.items():
        main, startup, loss = build(fluid, make)
        transpile(fluid, main, startup)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = {v.name: np.zeros([d if d > 0 else 8 for d in v.shape],
                                 np.float32)
                for v in main.list_vars() if v.is_data}
        try:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            res["errors"][name] = None
        except ValueError as e:
            res["errors"][name] = str(e)
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("pack_3d")
    proc = start_pack(Path(__file__), out_dir, nproc=NPROC)
    try:
        # every case published first, then JAX's runs while the ranks run
        runs = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, (make, transpile, feeds_fn, compiled, _r, _t) in \
                    CASES.items():
                feeds = feeds_fn()
                init, losses = jax_prepare(make, transpile,
                                           compiled=compiled)
                publish_case(out_dir, name, (init, feeds))
                runs[name] = (losses, feeds, init)
            fname, _make, twin, _r = FLEET
            publish_case(out_dir, fname, (runs[twin][2], runs[twin][1]))
            bname, _make, _t, twin, _tol = PP_BERT
            seq = bert_config().max_seq_len
            publish_case(out_dir, bname, (runs[twin][2], [
                rebase_mask_pos(f, PP_BERT_MICRO, seq)
                for f in runs[twin][1]]))
            ref = {name: losses(feeds)
                   for name, (losses, feeds, _i) in runs.items()}
    finally:
        done = wait_pack(proc, timeout=600)
    assert done.returncode == 0, \
        done.stderr[-3000:] + pack_logs(out_dir, NPROC)
    ranks = [json.loads((out_dir / ("rank%d.json" % r)).read_text())
             for r in range(NPROC)]
    return ranks, ref


def _mean_over_replicas(ranks, name, replicas):
    """Each replica's losses (the first rank of each), averaged."""
    n = len(ranks) // replicas
    return np.mean([ranks[i * n]["losses"][name] for i in range(replicas)],
                   axis=0)


def test_pack_ran_eight_gloo_ranks(pack):
    ranks, _ = pack
    assert [r["rank"] for r in ranks] == list(range(NPROC))
    assert all(r["world"] == NPROC for r in ranks)


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax(pack, name):
    """Every rank's per-step losses (a replica's: the mean over the
    replicas) against JAX's run of the same composition."""
    ranks, ref = pack
    _m, _t, _f, _c, replicas, tol = CASES[name]
    n = NPROC // replicas
    for i in range(replicas):
        group = ranks[i * n:(i + 1) * n]
        for r in group[1:]:
            np.testing.assert_allclose(r["losses"][name],
                                       group[0]["losses"][name],
                                       rtol=1e-6, atol=1e-6)
    got = _mean_over_replicas(ranks, name, replicas)
    np.testing.assert_allclose(got, ref[name], rtol=tol, atol=tol)
    assert np.all(np.isfinite(ref[name]))


# the collectives each composition must issue on every rank: each
# model axis engaged (no silent replicated run), the pipeline's sends and
# gradient sums over pp (a sharded parameter's gathered to the stage
# that reads it and its gradient reduce-scattered), the dp mean of
# dp-sharded pipeline feeds, the replicas' MoE tokens routed together
# over dp
ENGAGED = {
    "dp2_mp2_pp2": {"allreduce@mp", "send@pp", "allreduce@pp",
                    "allreduce@dp"},
    "dp4_pp2": {"send@pp", "allreduce@pp", "allreduce@dp", "gather@pp",
                "reducescatter@pp"},
    "at_width": {"allreduce@mp", "send@pp", "gather@pp",
                 "reducescatter@pp"},
    "pp2_sp2": {"sendrecv@sp", "send@pp", "allreduce@dp"},
    "pp2_mp2_sp2": {"allreduce@mp", "sendrecv@sp", "send@pp"},
    "pp2_ep4": {"send@pp"},
    "sp2_ep2_dp2": {"sendrecv@sp", "allgather@ep", "allgather@dp"},
    "sp4_ep2": {"sendrecv@sp", "allgather@ep"},
    "mp2_sp2_dp2": {"allreduce@mp", "sendrecv@sp"},
    "sp2_ep2_a2a_dp2": {"sendrecv@sp", "a2a@ep"},
    "sp2_dp4": {"sendrecv@sp", "allgather@dp"},
    "ep2_dp4": {"allgather@ep", "allgather@dp"},
    "bert_mp2_sp2": {"allreduce@mp", "a2a@sp"},
}


@pytest.mark.parametrize("name", sorted(ENGAGED))
def test_each_axis_is_engaged(pack, name):
    ranks, _ = pack
    for r in ranks:
        want = set(ENGAGED[name])
        if name == "pp2_ep4" and r["rank"] < 4:
            want.add("allgather@ep")       # the MoE is stage 0's (ranks 0-3)
        missing = want - set(r["comm"][name])
        assert not missing, (r["rank"], missing, r["comm"][name])


def test_bert_in_two_stages_at_mp2_matches_jax(pack):
    """Tiny BERT, embeddings and layer 0 on stage 0, layer 1 and the
    heads on stage 1, the Megatron pairs at mp 2, dp 2: every rank's
    losses are JAX's unpipelined run's on the same batches."""
    ranks, ref = pack
    name, _make, _t, twin, tol = PP_BERT
    for r in ranks:
        np.testing.assert_allclose(r["losses"][name], ref[twin], rtol=tol,
                                   atol=tol)
        assert {"allreduce@mp", "send@pp"} <= set(r["comm"][name])


def test_fleet_dp_route_with_mp_and_sp_matches_jax(pack):
    """fleet's DistributedStrategy(mp_degree=2, sp_degree=2) in a world
    of eight: the two replicas' gradients are all-reduced one by one over
    their dp group, and their mean loss is JAX's mp2 x sp2 x dp2 run's."""
    ranks, ref = pack
    name, _make, twin, replicas = FLEET
    got = _mean_over_replicas(ranks, name, replicas)
    np.testing.assert_allclose(got, ref[twin], rtol=MOE_TOL, atol=MOE_TOL)
    ops = ranks[0]["fleet_ops"]
    assert "c_allreduce_sum" in ops and "c_reducescatter" not in ops


def test_at_width_memory_fractions(pack):
    """A Megatron-paired weight and its velocity at 1/mp per rank, a
    stage parameter ([DW, 1], the prediction head) and its velocity at
    1/pp, and every rank's stored parameters and state at most 0.62 of
    the whole (JAX test_3d_at_width_memory_fractions' bounds)."""
    ranks, _ = pack
    import paddle_tpu.fluid as jfluid
    main, _s, _l = build(jfluid, wide_model)
    jax_shapes = {v.name: list(v.shape) for v in main.list_vars()
                  if v.persistable}
    for r in ranks:
        shapes = r["shapes"]["at_width"]
        links = r["links"]
        vel_of = {p: a for a, p in links.items() if "velocity" in a}
        mp_w = next(n for n in r["annotated"]
                    if np.prod(jax_shapes[n]) == DW * FW)
        pp_w = next(n for n, sh in jax_shapes.items()
                    if sh == [DW, 1] and n not in r["annotated"])

        def frac(name):
            return np.prod(shapes[name]) / np.prod(jax_shapes[name])
        assert frac(mp_w) <= 0.5 + 1e-6
        assert frac(vel_of[mp_w]) <= 0.5 + 1e-6
        assert frac(pp_w) <= 0.5 + 1e-6
        assert frac(vel_of[pp_w]) <= 0.5 + 1e-6
        names = set(links) | {n for n in jax_shapes if n in vel_of}
        stored = sum(np.prod(shapes[n]) for n in names)
        whole = sum(np.prod(jax_shapes[n]) for n in names)
        assert stored <= 0.62 * whole, (stored, whole)


def test_pipeline_experts_are_held_at_one_quarter(pack):
    """pp2 x ep4: each rank holds 1/4 of the experts of the stage-0
    switch_moe (JAX test_ep_composes_under_pipeline_mesh's bound)."""
    ranks, _ = pack
    for r in ranks:
        shapes = r["shapes"]["pp2_ep4"]
        w = [n for n in shapes if n.startswith("switch_moe") and
             len(shapes[n]) == 3]
        assert w and all(shapes[n][0] == 1 for n in w), shapes


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_with_jax_message(pack, name):
    """Stages issuing different collective islands, and the a2a dispatch
    under a pipeline, are refused on every rank with the JAX package's
    message, which the JAX package raises for the same program."""
    ranks, _ = pack
    make, transpile, msg = REFUSED[name]
    for r in ranks:
        assert r["errors"][name] is not None and msg in r["errors"][name]
    import paddle_tpu.fluid as jfluid
    main, startup, loss = build(jfluid, make)
    transpile(jfluid, main, startup)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {v.name: np.zeros(v.shape, np.float32) for v in main.list_vars()
            if v.is_data}
    with pytest.raises(Exception, match=msg):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def test_layout_of_a_pipelined_world():
    """Rank i of a (dp, pp, mp) layout holds the coordinates of JAX
    device i; each axis's line is its group."""
    from paddle_tpu_torch.fluid import mesh_utils
    layout = (("dp", 2), ("pp", 2), ("mp", 2))
    c = mesh_utils.Coords("pp", layout, 5)
    assert c.coords == {"dp": 1, "pp": 0, "mp": 1}
    assert c.group_ranks == [5, 7] and c.dp_ranks == [1, 5]
    m = mesh_utils.Coords("mp", layout, 5)
    assert m.group_ranks == [4, 5] and m.rank == 1
    assert m.fold(["mp"]) == 3 and m.fold([]) == 1


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
