"""The port's BERT encoder and ServingExecutor (paddle_tpu_torch) against
paddle_tpu on the CPU.

The same ``tiny_config`` (2 layers, width 64, 4 heads, S=32) builds in
both packages; the programs must have the same op types and var shapes.
The two startup programs draw from different random streams, so JAX's
startup weights are carried into the port's scope (``load_numpy_params``)
and both run the same numpy feeds.  Tolerance: ``rtol/atol 2e-4`` on
``enc_out`` (float32, two layers of different summation orders).

Bucket ladder, padding isolation and zero recompiles after warmup are
checked on the port alone (the JAX package's padding-isolation test
fails at the seed, so the property is checked directly here).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import serving
from paddle_tpu_torch.models import bert
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)
FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


def _build(pkg, bert_mod, cfg):
    main, startup = pkg.Program(), pkg.Program()
    S = cfg.max_seq_len
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        data = [pkg.layers.data(n, [S, 1],
                                dtype="float32" if n == "input_mask"
                                else "int64") for n in FEEDS]
        enc = bert_mod.bert_encoder(*data, cfg)
    return main, startup, enc


def _feed(cfg, lengths, seed=0):
    rng = np.random.RandomState(seed)
    B, S = len(lengths), cfg.max_seq_len
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (B, S, 1)).astype(np.int64),
        "pos_ids": np.tile(np.arange(S, dtype=np.int64).reshape(1, S, 1),
                           (B, 1, 1)),
        "sent_ids": rng.randint(0, 2, (B, S, 1)).astype(np.int64),
        "input_mask": (np.arange(S)[None, :, None] <
                       np.asarray(lengths)[:, None, None]).astype(np.float32),
    }


def _specs(cfg):
    S = cfg.max_seq_len
    return {n: ((S, 1), "float32" if n == "input_mask" else "int64")
            for n in FEEDS}


@pytest.fixture(scope="module")
def pair():
    """Both packages' tiny BERT, JAX's startup weights in both scopes,
    and JAX's enc_out on a reference batch."""
    cfg = jbert.tiny_config()
    jmain, jstartup, jenc = _build(jfluid, jbert, cfg)
    pcfg = bert.tiny_config()
    pmain, pstartup, penc = _build(fluid, bert, pcfg)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    arrays = {n: np.asarray(jscope.find_var(n)) for n in names}
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, arrays, fluid.CPUPlace())
    jinfer = jmain.clone(for_test=True)
    pinfer = pmain.clone(for_test=True)
    lengths = [32, 20, 7, 1, 32, 13]
    feed = _feed(cfg, lengths)
    want, = jexe.run(jinfer, feed=feed, fetch_list=[jenc], scope=jscope)
    return dict(cfg=pcfg, jprogs=(jmain, jstartup), pprogs=(pmain, pstartup),
                pinfer=pinfer, penc=penc, pscope=pscope, feed=feed,
                want=np.asarray(want), n_params=len(names))


def _program_summary(prog):
    block = prog.global_block()
    return ([op.type for op in block.ops],
            {n: (v.shape, v.dtype, v.persistable)
             for n, v in block.vars.items()})


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
def test_programs_have_the_same_ops_and_var_shapes(pair, which):
    jops, jvars = _program_summary(pair["jprogs"][which])
    pops, pvars = _program_summary(pair["pprogs"][which])
    assert pops == jops
    assert pvars == jvars
    if which == 1:
        assert set(pops) == {"truncated_gaussian_random", "fill_constant"}


def test_executor_matches_jax_enc_out(pair):
    assert pair["n_params"] > 20
    exe = fluid.Executor(fluid.CPUPlace())
    got, = exe.run(pair["pinfer"], feed=pair["feed"],
                   fetch_list=[pair["penc"]], scope=pair["pscope"])
    assert got.shape == pair["want"].shape == (6, 32, 64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pair["want"], **TOL)


def test_composition_path_matches_fused_path(pair):
    """use_fused_attention=False builds the matmul/softmax composition;
    with the same weights it gives the same enc_out."""
    cfg = bert.tiny_config(use_fused_attention=False)
    main, _, enc = _build(fluid, bert, cfg)
    ops = [op.type for op in main.global_block().ops]
    assert "fused_attention" not in ops and "softmax" in ops
    exe = fluid.Executor(fluid.CPUPlace())
    got, = exe.run(main.clone(for_test=True), feed=pair["feed"],
                   fetch_list=[enc], scope=pair["pscope"])
    np.testing.assert_allclose(got, pair["want"], **TOL)


def test_serving_executor_matches_jax_per_request(pair):
    feed, want = pair["feed"], pair["want"]
    sv = fluid.ServingExecutor(pair["pinfer"], feed_specs=_specs(pair["cfg"]),
                               fetch_list=[pair["penc"]],
                               scope=pair["pscope"], place=fluid.CPUPlace(),
                               max_batch=4, max_wait_ms=20)
    try:
        sv.warmup()
        splits = [(0, 1), (1, 4), (4, 6)]
        futs = [sv.submit({n: feed[n][a:b] for n in FEEDS})
                for a, b in splits]
        for (a, b), f in zip(splits, futs):
            out, = f.result(timeout=30)
            assert out.shape == (b - a, 32, 64)
            np.testing.assert_allclose(out, want[a:b], **TOL)
        st = sv.stats()
        assert st["responses"] == 3 and st["recompiles"] == 0
    finally:
        sv.close()


def test_bucket_ladder_defaults_and_overrides(monkeypatch):
    assert serving.bucket_ladder(8) == [1, 2, 4, 8]
    assert serving.bucket_ladder(6) == [1, 2, 4, 6]
    assert serving.bucket_ladder(64, buckets=[16, 4, 4]) == [4, 16]
    with pytest.raises(ValueError):
        serving.bucket_ladder(8, buckets=[0, 2])
    monkeypatch.setitem(fluid.flags._cache, "serving_buckets", "3, 9")
    assert serving.bucket_ladder(64) == [3, 9]


def test_padding_isolation_and_zero_recompiles_across_the_ladder(pair):
    """Every request, co-batched in random groups with rows of extreme
    values (max token ids, all-ones masks, segment 1), answers as it does
    alone; after warmup no dispatch builds a new plan."""
    cfg, scope = pair["cfg"], pair["pscope"]
    exe = fluid.Executor(fluid.CPUPlace())
    sv = fluid.ServingExecutor(pair["pinfer"], feed_specs=_specs(cfg),
                               fetch_list=[pair["penc"]], scope=scope,
                               executor=exe, max_batch=8, max_wait_ms=30)
    rng = np.random.RandomState(7)
    try:
        sv.warmup()
        plans = exe.compile_count()
        probes = []
        for i in range(6):
            rows = int(rng.randint(1, 4))
            f = _feed(cfg, rng.randint(1, 33, rows), seed=100 + i)
            alone, = exe.run(pair["pinfer"], feed=f,
                             fetch_list=[pair["penc"]], scope=scope)
            probes.append((f, alone))
        extreme = _feed(cfg, [32] * 3, seed=1)
        extreme["src_ids"][:] = cfg.vocab_size - 1
        extreme["sent_ids"][:] = 1
        plans = exe.compile_count()
        futs = []
        for f, _ in probes:
            futs.append(sv.submit(f))
            futs.append(sv.submit(extreme))
        for i, (f, alone) in enumerate(probes):
            out, = futs[2 * i].result(timeout=30)
            np.testing.assert_allclose(out, alone, **TOL)
        for fut in futs[1::2]:
            assert np.isfinite(fut.result(timeout=30)[0]).all()
        st = sv.stats()
        assert st["recompiles"] == 0
        assert exe.compile_count() == plans
        assert st["batches"] >= 2 and st["responses"] == 12
    finally:
        sv.close()


def test_default_place_is_the_card():
    """Executor() and ServingExecutor(place=None) target cuda:0; with no
    card they raise instead of falling back to the host."""
    import torch
    if torch.cuda.is_available():
        assert fluid.Executor().device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fluid.ServingExecutor(fluid.Program(), feed_specs={"x": ((1,), "f4")},
                              fetch_list=["x"])


def test_unported_routes_raise_naming_the_roadmap(pair):
    """The training program (train-mode dropout) now runs on CPUPlace;
    the route still left for a later slice raises, naming ROADMAP.md,
    instead of computing something else: a fused_attention op stamped for
    sequence parallelism.  Loading a saved inference model is ported
    (tests/test_torch_inference.py): it loads onto the card unless asked
    for the CPU, and never falls back to the host."""
    main = pair["pprogs"][0]
    exe = fluid.Executor(fluid.CPUPlace())
    got, = exe.run(main, feed=pair["feed"], fetch_list=[pair["penc"]],
                   scope=pair["pscope"])
    assert got.shape == pair["want"].shape and np.isfinite(got).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fluid.ServingExecutor.from_inference_model("model_dir")
    with pytest.raises(FileNotFoundError):
        fluid.ServingExecutor.from_inference_model(
            "model_dir", place=fluid.CPUPlace())
    sp = main.clone(for_test=True)
    for op in sp.global_block().ops:
        if op.type == "fused_attention":
            op._set_attr("sp_axis", "sp")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        exe.run(sp, feed=pair["feed"], fetch_list=[pair["penc"]],
                scope=pair["pscope"])
