"""Expert parallelism in the port (``layers.switch_moe``,
``ExpertParallelTranspiler``, fleet's ``ep_degree``,
``paddle_tpu_torch/parallel/expert_parallel.py``, ``ops/moe_ops.py``,
``quantized_collectives.quantized_all_to_all``) in a world of two ranks
against paddle_tpu at the same degree on its virtual CPU mesh.

One 2-process gloo pack (this file is its worker) runs every port side;
the JAX side runs in this process.

- ``quantized_all_to_all`` at fp32, bf16 and int8 (split 0 / concat 1,
  the MoE dispatch's layout) and ``switch_moe_sharded`` (outputs, aux
  loss, and each rank's gradients) and the one-expert-per-rank
  ``switch_moe`` against JAX's under ``shard_map`` within 1e-5;
  ``route_tokens``' expert choice, slots and combine exactly (the fp32
  gates within an ulp) and ``aux_load_balance_loss``;
- per-step losses of 4 steps within 3e-5 for the JAX MoE composition
  test's transformer block (attention, then a ``switch_moe`` FFN) at
  ep 2: the dense dispatch (capacity 1.25, tokens dropped by global
  order), and the GShard all-to-all island at fp32, bf16 and int8
  (capacity 8, no drops: per-shard capacity then equals the global
  one), and through fleet's ``ep_degree=2``;
- each rank holds half of the experts and of their momentum, and the
  island's wire bytes are recorded as the JAX op records them;
- in this process: the transpiled programs equal JAX's op for op, the
  fleet knobs and the validation errors match.
"""

import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid

from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_tensor_parallel import (LOSS_TOL, NPROC, PRIM_TOL, STEPS,
                                        build, jax_cases_and_pack,
                                        load_case, op_listing, port_run)

B, S, H, D = 8, 16, 4, 8
DM = H * D
E, F = 4, 32


def moe_block(cf=1.25, strategy=None):
    """tests/test_moe_transformer_composition.py's block."""
    def b(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[S, DM], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.1, 0.1))
        q = L.transpose(L.reshape(L.fc(x, size=DM, num_flatten_dims=2,
                                       param_attr=uni), [0, S, H, D]),
                        [0, 2, 1, 3])
        ctx = L.fused_attention(q, q, q, scale=D ** -0.5)
        h = x + L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, S, DM])
        moe_out, aux = L.switch_moe(h, num_experts=E, ffn_dim=F,
                                    act="gelu", param_attr=uni,
                                    capacity_factor=cf)
        h = h + moe_out
        logits = L.fc(L.reduce_mean(h, dim=1), size=8, param_attr=uni)
        ce = L.mean(L.softmax_with_cross_entropy(logits, label))
        loss = ce + 0.01 * L.reduce_sum(aux)
        opt = pkg.optimizer.MomentumOptimizer(0.05, 0.9)
        if strategy is not None:
            from importlib import import_module
            base = pkg.__name__.rsplit(".", 1)[0]
            coll = import_module(base + ".fluid.incubate.fleet.collective")
            opt = coll.CollectiveOptimizer(opt, coll.DistributedStrategy(
                **strategy))
        opt.minimize(loss)
        return loss
    return b


def ep(dispatch="dense", precision="fp32"):
    def t(pkg, main, startup):
        pkg.transpiler.ExpertParallelTranspiler(
            NPROC, dispatch=dispatch,
            dispatch_precision=precision).transpile(main, startup)
    return t


def moe_feeds(seed=33):
    rng = np.random.RandomState(seed)
    return [{"x": rng.normal(0, 1, (B, S, DM)).astype(np.float32),
             "label": rng.randint(0, 8, (B, 1)).astype(np.int64)}
            for _ in range(STEPS)]


CASES = {    # name: (make, transpile, feeds, through with_data_parallel)
    "dense": (moe_block(), ep(), moe_feeds, False),
    "a2a_fp32": (moe_block(8.0), ep("a2a"), moe_feeds, False),
    "a2a_bf16": (moe_block(8.0), ep("a2a", "bf16"), moe_feeds, False),
    "a2a_int8": (moe_block(8.0), ep("a2a", "int8"), moe_feeds, False),
    "fleet": (moe_block(strategy={"ep_degree": NPROC}), None, moe_feeds,
              False),
}


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------

PN, PE, PF = 16, 4, 8


def a2a_input():
    return np.random.RandomState(1).randn(NPROC, PE, 3, 6).astype(
        np.float32)


def moe_inputs():
    rng = np.random.RandomState(2)
    return {"x": rng.randn(NPROC * PN, 6).astype(np.float32),
            "router": rng.randn(6, PE).astype(np.float32),
            "w1": rng.randn(PE, 6, PF).astype(np.float32) * 0.3,
            "w2": rng.randn(PE, PF, 6).astype(np.float32) * 0.3,
            "g": rng.randn(NPROC * PN, 6).astype(np.float32)}


def switch1_inputs():
    """One expert per rank: tokens [2 x 8, 6], router [6, 2], each rank's
    expert [6, 8] / [8, 6]."""
    rng = np.random.RandomState(4)
    return {"x": rng.randn(NPROC * 8, 6).astype(np.float32),
            "router": rng.randn(6, NPROC).astype(np.float32),
            "w1": rng.randn(NPROC, 6, 8).astype(np.float32) * 0.3,
            "w2": rng.randn(NPROC, 8, 6).astype(np.float32) * 0.3}


def port_primitives(rank):
    import torch
    from paddle_tpu_torch.fluid.quantized_collectives import \
        quantized_all_to_all
    from paddle_tpu_torch.parallel import switch_moe_sharded
    out = {}
    x = torch.from_numpy(a2a_input()[rank])
    for prec in ("fp32", "bf16", "int8"):
        out["a2a_" + prec] = quantized_all_to_all(x, None, 0, 1,
                                                  prec).tolist()
    a = moe_inputs()
    el = PE // NPROC
    sl = slice(rank * PN, (rank + 1) * PN)
    xs = [torch.from_numpy(a["x"][sl].copy()).requires_grad_(),
          torch.from_numpy(a["router"]).requires_grad_(),
          torch.from_numpy(a["w1"][rank * el:(rank + 1) * el].copy())
          .requires_grad_(),
          torch.from_numpy(a["w2"][rank * el:(rank + 1) * el].copy())
          .requires_grad_()]
    o, aux = switch_moe_sharded(*xs, capacity_factor=1.25)
    (o * torch.from_numpy(a["g"][sl])).sum().backward()
    out["moe"] = {"out": o.detach().tolist(), "aux": float(aux),
                  "grads": [t.grad.tolist() for t in xs]}
    from paddle_tpu_torch.parallel import switch_moe
    b = {k: torch.from_numpy(v) for k, v in switch1_inputs().items()}
    out["switch1"] = switch_moe(b["x"][rank * 8:(rank + 1) * 8], b["router"],
                                b["w1"][rank], b["w2"][rank]).tolist()
    return out


def jax_primitives():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.fluid.mesh_utils import shard_map
    from paddle_tpu.fluid.quantized_collectives import quantized_all_to_all
    from paddle_tpu.parallel import switch_moe_sharded
    mesh = Mesh(np.array(jax.devices()[:NPROC]), ("ep",))
    out = {}
    xg = a2a_input().reshape(NPROC * PE, 3, 6)
    for prec in ("fp32", "bf16", "int8"):
        fn = shard_map(lambda t, p=prec: quantized_all_to_all(
            t, "ep", split_axis=0, concat_axis=1, precision=p),
            mesh=mesh, in_specs=(P("ep"),), out_specs=P("ep"),
            check_vma=False)
        out["a2a_" + prec] = np.asarray(jax.jit(fn)(xg)).reshape(
            NPROC, PE // NPROC, NPROC * 3, 6)
    a = {k: jnp.asarray(v) for k, v in moe_inputs().items()}

    def body(x, r, w1, w2, g):
        def loss(x_, r_, w1_, w2_):
            o, _aux = switch_moe_sharded(x_, r_, w1_, w2_, axis="ep",
                                         capacity_factor=1.25)
            return jnp.sum(o * g)
        o, aux = switch_moe_sharded(x, r, w1, w2, axis="ep",
                                    capacity_factor=1.25)
        grads = jax.grad(loss, (0, 1, 2, 3))(x, r, w1, w2)
        return (o, aux[None]) + grads

    specs = (P("ep"), P(), P("ep"), P("ep"), P("ep"))
    res = jax.jit(shard_map(
        body, mesh=mesh, in_specs=specs,
        out_specs=(P("ep"), P("ep"), P("ep"), P("ep"), P("ep"), P("ep")),
        check_vma=False))(a["x"], a["router"], a["w1"], a["w2"], a["g"])
    out["moe"] = [np.asarray(t) for t in res]
    from paddle_tpu.parallel import switch_moe
    b = {k: jnp.asarray(v) for k, v in switch1_inputs().items()}
    out["switch1"] = np.asarray(jax.jit(shard_map(
        lambda x, r, w1, w2: switch_moe(x, r, w1[0], w2[0], axis="ep"),
        mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=P("ep"), check_vma=False))(b["x"], b["router"], b["w1"],
                                              b["w2"]))
    return out


# ---------------------------------------------------------------------------
# The pack
# ---------------------------------------------------------------------------

def worker(out_dir):
    import torch
    from paddle_tpu_torch.fluid import distributed as dist, telemetry
    torch.set_num_threads(1)
    rank, n = dist.init(place=fluid.CPUPlace())
    res = {"rank": rank, "world": n, "losses": {}, "shapes": {},
           "comm_by": {}}
    res["prims"] = port_primitives(rank)
    for name, (make, transpile, _f, _c) in CASES.items():
        init, feeds = load_case(out_dir, name)
        losses, scope, main = port_run(make, transpile, feeds, init)
        res["losses"][name] = losses
        res["comm_by"][name] = dict(telemetry.step_events()[-1]["comm_by"]
                                    or {})
        res["shapes"][name] = {
            nm: list(scope.find_var(nm).shape)
            for nm in scope.var_names() if "switch_moe" in nm}
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    return jax_cases_and_pack(Path(__file__),
                              tmp_path_factory.mktemp("ep_pack"), CASES)


@pytest.mark.parametrize("prec", ["fp32", "bf16", "int8"])
def test_quantized_all_to_all_matches_jax(pack, prec):
    ranks, _ = pack
    want = jax_primitives()["a2a_" + prec]
    for r in ranks:
        np.testing.assert_allclose(r["prims"]["a2a_" + prec],
                                   want[r["rank"]], rtol=PRIM_TOL,
                                   atol=PRIM_TOL)


def test_switch_moe_sharded_matches_jax(pack):
    ranks, _ = pack
    o, aux, gx, gr, gw1, gw2 = jax_primitives()["moe"]
    el = PE // NPROC
    for r in ranks:
        k = r["rank"]
        got = r["prims"]["moe"]
        np.testing.assert_allclose(got["out"], o[k * PN:(k + 1) * PN],
                                   rtol=PRIM_TOL, atol=PRIM_TOL)
        np.testing.assert_allclose(got["aux"], aux[0], rtol=PRIM_TOL)
        want = [gx[k * PN:(k + 1) * PN], gr[k * 6:(k + 1) * 6],
                gw1[k * el:(k + 1) * el], gw2[k * el:(k + 1) * el]]
        # the router's gradient is each rank's part on both sides (the op
        # rule sums the parts with copy_to)
        for g, w in zip(got["grads"], want):
            np.testing.assert_allclose(g, w, rtol=PRIM_TOL, atol=PRIM_TOL)


def test_one_expert_per_rank_switch_moe_matches_jax(pack):
    ranks, _ = pack
    want = jax_primitives()["switch1"]
    for r in ranks:
        k = r["rank"]
        np.testing.assert_allclose(r["prims"]["switch1"],
                                   want[k * 8:(k + 1) * 8], rtol=PRIM_TOL,
                                   atol=PRIM_TOL)


def test_aux_load_balance_loss_matches_jax():
    import jax.numpy as jnp
    import torch
    from paddle_tpu.parallel import aux_load_balance_loss as jaux
    from paddle_tpu_torch.parallel import aux_load_balance_loss
    rng = np.random.RandomState(6)
    gates = rng.dirichlet(np.ones(PE), 32).astype(np.float32)
    expert = gates.argmax(-1)
    want = float(jaux(jnp.asarray(gates), jnp.asarray(expert)))
    got = float(aux_load_balance_loss(torch.from_numpy(gates),
                                      torch.from_numpy(expert)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_route_tokens_matches_jax():
    """The expert choice (first index on a tie), the one-hot, the
    capacity slots and the combine tensor are JAX's exactly; the fp32
    softmax gates within an ulp."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu.parallel import route_tokens as jroute
    from paddle_tpu_torch.parallel import route_tokens
    a = moe_inputs()
    x = a["x"].copy()
    x[3] = x[4]                       # a tie in token order
    for cap in (2, 5, 40):
        want = jroute(jnp.asarray(x), jnp.asarray(a["router"]), PE, cap)
        got = route_tokens(torch.from_numpy(x),
                           torch.from_numpy(a["router"]), PE, cap)
        for i, (w, g) in enumerate(zip(want, got)):
            if i in (0, 2):           # gates, gate
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax_at_ep2(pack, name):
    ranks, ref = pack
    for r in ranks:
        np.testing.assert_allclose(r["losses"][name], ref[name],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    assert np.all(np.isfinite(ref[name]))


def test_each_rank_holds_half_of_the_experts(pack):
    ranks, _ = pack
    for r in ranks:
        shapes = r["shapes"]["dense"]
        assert shapes["switch_moe_0.w_1"] == [E // NPROC, DM, F]
        assert shapes["switch_moe_0.w_2"] == [E // NPROC, F, DM]
        assert shapes["switch_moe_0.w_0"] == [DM, E]
        vel = [n for n in shapes if n.startswith("switch_moe_0.w_1_vel")]
        assert vel and shapes[vel[0]] == [E // NPROC, DM, F]


@pytest.mark.parametrize("prec", ["fp32", "bf16", "int8"])
def test_a2a_wire_bytes_are_recorded(pack, prec):
    from paddle_tpu_torch.fluid.quantized_collectives import \
        alltoall_wire_bytes
    ranks, _ = pack
    C = int(math.ceil(8.0 * (B * S // NPROC) / E))
    want = 2 * alltoall_wire_bytes((E, C, DM), prec)
    for r in ranks:
        by = r["comm_by"]["a2a_" + prec]
        assert by == {"a2a_%s" % prec: want}
    assert ranks[0]["comm_by"]["dense"] == {}


@pytest.mark.parametrize("name", ["dense", "a2a_int8", "fleet"])
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
    assert pm._ep_degree == jm._ep_degree == NPROC
    for po, jo in zip(pm.global_block().ops, jm.global_block().ops):
        if po.type.startswith("switch_moe"):
            for key in ("ep_axis", "moe_dispatch",
                        "moe_dispatch_precision"):
                assert po.attr(key) == jo.attrs.get(key)


def test_validation_matches_jax():
    import paddle_tpu.fluid as jfluid
    for pkg in (jfluid, fluid):
        T = pkg.transpiler.ExpertParallelTranspiler
        main, _s, _l = build(pkg, moe_block())
        with pytest.raises(ValueError, match="not divisible"):
            T(3).transpile(main)
        with pytest.raises(ValueError, match="dispatch"):
            T(2, dispatch="ring")
        with pytest.raises(ValueError, match="dispatch_precision"):
            T(2, dispatch_precision="fp8")
        with pytest.raises(ValueError, match="no switch_moe"):
            T(2).transpile(pkg.Program())


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
