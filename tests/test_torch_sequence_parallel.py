"""Sequence parallelism in the port (``SequenceParallelTranspiler``,
fleet's ``sp_degree``/``sp_mode``, ``paddle_tpu_torch/parallel/
sequence_parallel.py``, the sequence-parallel routes of
``fused_attention`` and ``fluid/model_parallel.py``) in a world of two
ranks against paddle_tpu at the same degree on its virtual CPU mesh.

One 2-process gloo pack (this file is its worker) runs every port side;
the JAX side runs in this process.

- the primitives on ``[B, T/2, H, D]`` shards, outputs and each rank's
  gradients against JAX's under ``shard_map`` within 1e-5: the einsum
  ring causal and biased; the flash ring (K2 with the LSE per step, K3
  and K4 with the global LSE; on the CPU their plain versions) against
  JAX's ``use_flash=True`` in Pallas interpret mode; Ulysses causal, with
  a per-head and with a broadcast bias;
- per-step losses of 4 steps within 3e-5 for the JAX SP tests' attention
  model (ring, ring causal, Ulysses, Ulysses causal, Ulysses through
  ``with_data_parallel``), a cross-attention model (the q-row gather
  route, k/v all-gathered) and tiny BERT with its padding bias (ring:
  the einsum ring; Ulysses: the bias gathered on the q dim);
- port only: attention dropout under SP takes the gather route with the
  rank folded into the mask's seed, and the loss is the same on both
  ranks;
- in this process: the transpiled programs equal JAX's op for op with the
  same feed dims, and the validation errors match.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid

from test_torch_common import _empty_jax_step_event_ring  # noqa: F401
from test_torch_tensor_parallel import (LOSS_TOL, NPROC, PRIM_TOL, STEPS,
                                        bert_feed, bert_program, build,
                                        jax_cases_and_pack, load_case,
                                        op_listing, port_run)

B, S, H, D = 8, 16, 8, 4
DM = H * D
PB, PT, PH, PD = 2, 32, 4, 16
TL = PT // NPROC


# ---------------------------------------------------------------------------
# Programs, built the same way in both packages
# ---------------------------------------------------------------------------

def attn_model(causal=False, dropout=0.0, cross=False):
    """The JAX SP test's attention block over [B, S, DM] + FFN + CE;
    ``cross`` takes k/v from a memory feed of length 2S."""
    def b(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[S, DM], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        mem = L.data(name="mem", shape=[2 * S, DM], dtype="float32") \
            if cross else x
        uni = pkg.ParamAttr(initializer=pkg.initializer.Uniform(-0.1, 0.1))

        def proj(inp, size, act=None):
            return L.fc(inp, size=size, num_flatten_dims=2, param_attr=uni,
                        act=act)

        def heads(t, n):
            return L.transpose(L.reshape(t, [0, n, H, D]), [0, 2, 1, 3])

        n_kv = 2 * S if cross else S
        q = heads(proj(x, DM), S)
        k, v = heads(proj(mem, DM), n_kv), heads(proj(mem, DM), n_kv)
        ctx = L.fused_attention(q, k, v, scale=D ** -0.5, causal=causal,
                                dropout_prob=dropout)
        ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, S, DM])
        h = proj(proj(ctx, DM * 2, act="gelu"), DM)
        pooled = L.reduce_mean(x + h, dim=1)
        logits = L.fc(pooled, size=8, param_attr=uni)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.MomentumOptimizer(learning_rate=0.1,
                                        momentum=0.9).minimize(loss)
        return loss
    return b


def sp(mode="ring"):
    def t(pkg, main, startup):
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pkg.transpiler.SequenceParallelTranspiler(
                NPROC, mode=mode).transpile(main, startup)
    return t


def attn_feeds(seed=3, cross=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        f = {"x": rng.normal(0, 1, (B, S, DM)).astype(np.float32),
             "label": rng.randint(0, 8, (B, 1)).astype(np.int64)}
        if cross:
            f["mem"] = rng.normal(0, 1, (B, 2 * S, DM)).astype(np.float32)
        out.append(f)
    return out


def sp_bert_config():
    """tests/test_bert_acceptance.py:176's configuration."""
    from paddle_tpu_torch.models import bert
    return bert.tiny_config(hidden_size=64, num_layers=2, num_heads=4,
                            max_seq_len=32, vocab_size=512, max_position=64,
                            attn_dropout=0.0, hidden_dropout=0.0)


def sp_bert_feeds(seed=5):
    rng = np.random.RandomState(seed)
    return [bert_feed(rng, sp_bert_config(), 8, 4) for _ in range(STEPS)]


CASES = {    # name: (make, transpile, feeds, through with_data_parallel)
    "attn_ring": (attn_model(), sp("ring"), attn_feeds, False),
    "attn_ring_causal": (attn_model(True), sp("ring"), attn_feeds, False),
    "attn_ulysses": (attn_model(), sp("ulysses"), attn_feeds, False),
    "attn_ulysses_causal": (attn_model(True), sp("ulysses"), attn_feeds,
                            False),
    "attn_ulysses_compiled": (attn_model(), sp("ulysses"), attn_feeds,
                              True),
    "cross": (attn_model(cross=True), sp("ring"),
              lambda: attn_feeds(cross=True), False),
    "bert_ring": (bert_program(sp_bert_config()), sp("ring"),
                  sp_bert_feeds, False),
    "bert_ulysses": (bert_program(sp_bert_config()), sp("ulysses"),
                     sp_bert_feeds, False),
}


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------

PRIMS = {
    # id: (fn name, causal, bias heads or None, use_flash)
    "ring_causal": ("ring", True, None, None),
    "ring_bias": ("ring", False, 1, None),
    "ring_flash": ("ring", False, None, True),
    "ulysses_causal": ("ulysses", True, None, None),
    "ulysses_bias_heads": ("ulysses", False, PH, None),
    "ulysses_bias_bcast": ("ulysses", False, 1, None),
}


def prim_inputs(name):
    rng = np.random.RandomState(sorted(PRIMS).index(name))
    q, k, v, g = (rng.randn(PB, PT, PH, PD).astype(np.float32) * 0.3
                  for _ in range(4))
    hb = PRIMS[name][2]
    bias = None if hb is None else \
        (rng.randn(PB, hb, PT, PT) * 0.5).astype(np.float32)
    return q, k, v, g, bias


def port_primitive(name, rank):
    import torch
    from paddle_tpu_torch import parallel
    fn, causal, _hb, use_flash = PRIMS[name]
    q, k, v, g, bias = prim_inputs(name)
    sl = slice(rank * TL, (rank + 1) * TL)
    xs = [torch.from_numpy(t[:, sl].copy()).requires_grad_()
          for t in (q, k, v)]
    kw = {}
    if bias is not None:
        kw["bias"] = torch.from_numpy(bias[:, :, sl].copy())
    if use_flash is not None:
        kw["use_flash"] = use_flash
    f = parallel.ring_attention if fn == "ring" else \
        parallel.ulysses_attention
    out = f(*xs, causal=causal, **kw)
    (out * torch.from_numpy(g[:, sl].copy())).sum().backward()
    return {"out": out.detach().tolist(),
            "grads": [x.grad.tolist() for x in xs]}


def jax_primitive(name):
    """JAX's output and gradients over a 2-device 'sp' mesh: each device
    differentiates its local loss, the transposed collectives route the
    cotangents home (tests/test_sequence_parallel.py's method)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.fluid.mesh_utils import shard_map
    from paddle_tpu.parallel import ring_attention, ulysses_attention
    fn, causal, _hb, use_flash = PRIMS[name]
    q, k, v, g, bias = prim_inputs(name)
    mesh = Mesh(np.array(jax.devices()[:NPROC]), ("sp",))

    def attend(a, b, c, bb):
        kw = {"bias": bb} if bb is not None else {}
        if fn == "ring":
            return ring_attention(a, b, c, "sp", causal=causal,
                                  use_flash=use_flash, **kw)
        return ulysses_attention(a, b, c, "sp", causal=causal, **kw)

    def body(a, b, c, gg, *rest):
        bb = rest[0] if rest else None
        out = attend(a, b, c, bb)
        grads = jax.grad(lambda x, y, z: jnp.sum(attend(x, y, z, bb) * gg),
                         (0, 1, 2))(a, b, c)
        return (out,) + grads

    spec = P(None, "sp")
    args = [q, k, v, g] + ([bias] if bias is not None else [])
    specs = (spec,) * 4 + ((P(None, None, "sp"),) if bias is not None
                           else ())
    res = jax.jit(shard_map(body, mesh=mesh, in_specs=specs,
                            out_specs=(spec,) * 4, check_vma=False))(*args)
    return [np.asarray(r) for r in res]


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
           "prims": {}}
    for name in PRIMS:
        res["prims"][name] = port_primitive(name, rank)
    for name, (make, transpile, _f, compiled) in CASES.items():
        init, feeds = load_case(out_dir, name)
        ptp.reset_comm()
        res["losses"][name] = port_run(make, transpile, feeds, init,
                                       compiled=compiled)[0]
        res["comm"][name] = {"%s@%s" % k: list(v)
                             for k, v in ptp.comm.items()}
    # attention dropout under SP: the gather route, rank-folded masks
    init, feeds = load_case(out_dir, "attn_ring")
    res["losses"]["dropout"] = port_run(attn_model(dropout=0.3), sp("ring"),
                                        feeds, init)[0]
    dist.barrier("end")
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.shutdown()


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    return jax_cases_and_pack(Path(__file__),
                              tmp_path_factory.mktemp("sp_pack"), CASES)


@pytest.mark.parametrize("name", sorted(PRIMS))
def test_primitive_matches_jax(pack, name):
    ranks, _ = pack
    want = jax_primitive(name)
    for r in ranks:
        sl = slice(r["rank"] * TL, (r["rank"] + 1) * TL)
        got = r["prims"][name]
        np.testing.assert_allclose(got["out"], want[0][:, sl],
                                   rtol=PRIM_TOL, atol=PRIM_TOL)
        for gg, w in zip(got["grads"], want[1:]):
            np.testing.assert_allclose(gg, w[:, sl], rtol=PRIM_TOL,
                                       atol=PRIM_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_match_jax_at_sp2(pack, name):
    ranks, ref = pack
    for r in ranks:
        np.testing.assert_allclose(r["losses"][name], ref[name],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    assert np.all(np.isfinite(ref[name]))


def test_ring_and_ulysses_move_what_they_should(pack):
    """A ring step rotates k and v (forward) and their gradients
    (backward); Ulysses swaps q, k, v and the output by all-to-all; BERT
    all-gathers its encoder output (the MLM gather and the pooler's
    first-token slice are not row-wise) and the input mask (the
    pairwise mask product)."""
    ranks, _ = pack
    for r in ranks:
        ring = r["comm"]["attn_ring"]
        assert ring["sendrecv@sp"][0] > 0 and "a2a@sp" not in ring
        uly = r["comm"]["attn_ulysses"]
        assert uly["a2a@sp"][0] == 8 * STEPS and "sendrecv@sp" not in uly
        assert r["comm"]["bert_ring"]["allgather@sp"][0] == 3 * STEPS
        assert "allgather@sp" in r["comm"]["cross"]


def test_attention_dropout_under_sp_trains(pack):
    ranks, ref = pack
    a, b = ranks[0]["losses"]["dropout"], ranks[1]["losses"]["dropout"]
    assert a == b and np.all(np.isfinite(a))
    assert a != ranks[0]["losses"]["attn_ring"]


@pytest.mark.parametrize("name", ["attn_ring", "attn_ulysses_causal",
                                  "cross", "bert_ring"])
def test_transpiled_program_matches_jax_op_for_op(name):
    import paddle_tpu.fluid as jfluid
    make, transpile, _f, _c = CASES[name]
    progs = {}
    for pkg in (jfluid, fluid):
        main, startup, _loss = build(pkg, make)
        transpile(pkg, main, startup)
        progs[pkg.__name__] = main
    jm, pm = progs["paddle_tpu.fluid"], progs["paddle_tpu_torch.fluid"]
    assert op_listing(pm) == op_listing(jm)
    assert pm._sp_feed_dims == jm._sp_feed_dims
    assert (pm._sp_degree, pm._sp_mode) == (jm._sp_degree, jm._sp_mode)
    stamped = [(op.type, op.attr("sp_axis"), op.attr("sp_mode"))
               for op in pm.global_block().ops
               if op.type.startswith("fused_attention")]
    assert stamped == [(op.type, op.attrs.get("sp_axis"),
                        op.attrs.get("sp_mode"))
                       for op in jm.global_block().ops
                       if op.type.startswith("fused_attention")]


def test_validation_matches_jax():
    import paddle_tpu.fluid as jfluid
    for pkg in (jfluid, fluid):
        main, _s, _l = build(pkg, attn_model())
        T = pkg.transpiler.SequenceParallelTranspiler
        with pytest.raises(ValueError, match="not divisible"):
            T(5).transpile(main)
        with pytest.raises(ValueError, match="heads"):
            T(16, mode="ulysses").transpile(main)
        with pytest.raises(ValueError, match="no fused_attention"):
            T(2).transpile(pkg.Program())
        with pytest.raises(ValueError, match="mode"):
            T(2, mode="zigzag")


def test_fleet_sp_knob_matches_jax():
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid.incubate.fleet import collective as jcoll
    from paddle_tpu_torch.fluid.incubate.fleet import collective as pcoll
    got = []
    for pkg, coll in ((jfluid, jcoll), (fluid, pcoll)):
        def b(p, coll=coll):
            L = p.layers
            x = L.data(name="x", shape=[S, DM], dtype="float32")
            q = L.transpose(L.reshape(x, [0, S, H, D]), [0, 2, 1, 3])
            loss = L.mean(L.fused_attention(q, q, q, scale=0.5))
            coll.CollectiveOptimizer(
                p.optimizer.SGDOptimizer(0.1),
                coll.DistributedStrategy(sp_degree=2, sp_mode="ulysses")
            ).minimize(loss)
            return loss
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            main, _s, _l = build(pkg, b)
        got.append((main._sp_degree, main._sp_mode,
                    dict(main._sp_feed_dims), op_listing(main)))
    assert got[0] == got[1]


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2])
