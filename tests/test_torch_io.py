"""The port's ``fluid.io`` against paddle_tpu on the CPU: exports of one
package serve in the other, strict loads, crash safety, the I/O ops.

- A tiny BERT encoder (2 layers, width 64) exported by paddle_tpu's
  ``save_inference_model`` — parameters one file per variable, and
  combined into one ``params_filename`` file — loads into the port, and
  the port's ``Executor`` gives the JAX outputs within rtol 1e-5 /
  atol 1e-6 (fp32) at every real token position.  Padding positions are
  held to atol 1e-4: every score of such a row sits at -1e4 + O(1),
  where float32's spacing is ~1e-3, so two summation orders move the
  row's output (measured 1.7e-5; ROADMAP queue 3).  The port's exports
  load into paddle_tpu the same way, and both packages write
  byte-identical ``__model__`` files and parameter streams for the same
  program and weights.
- Strict loads name the missing variable; a kill at every write boundary
  of an export leaves the previous model directory complete.
- The ``save``/``load``/``save_combine``/``load_combine`` ops in a
  program, a bfloat16 variable among them (bit for bit), and reference
  LoDTensor files read by ``load`` and ``load_combine``.
- ``prune_program`` drops the training ops; the order manifest's feed
  order is honoured.
"""

import glob
import io
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import proto_compat
from paddle_tpu_torch.models import bert

from test_torch_checkpoint import SimulatedCrash, crash_at, record_points
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

CPU = fluid.CPUPlace()
FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")
RTOL, ATOL = 1e-5, 1e-6
PAD_ATOL = 1e-4


def assert_encoder_close(got, want, feed):
    """Real token positions at RTOL/ATOL, padding positions at PAD_ATOL."""
    real = feed["input_mask"][..., 0] > 0
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[~real], want[~real], rtol=0,
                               atol=PAD_ATOL)


def build_encoder(pkg, mod):
    cfg = mod.tiny_config()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        data = [pkg.layers.data(n, [cfg.max_seq_len, 1],
                                dtype="float32" if n == "input_mask"
                                else "int64") for n in FEEDS]
        enc = mod.bert_encoder(*data, cfg)
    return main, startup, enc, cfg


def encoder_feed(cfg, rows=3, seed=0):
    rng = np.random.RandomState(seed)
    S = cfg.max_seq_len
    lengths = rng.randint(S // 2, S + 1, rows)
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (rows, S, 1)),
        "pos_ids": np.tile(np.arange(S).reshape(1, S, 1), (rows, 1, 1)),
        "sent_ids": rng.randint(0, 2, (rows, S, 1)),
        "input_mask": (np.arange(S)[None, :, None] <
                       lengths[:, None, None]).astype(np.float32),
    }


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """paddle_tpu's startup weights, its encoder outputs on one feed, and
    its two exports; the port's exports of the same program with the same
    weights."""
    root = tmp_path_factory.mktemp("exports")
    jmain, jstartup, jenc, cfg = build_encoder(jfluid, jbert)
    feed = encoder_feed(cfg)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        infer = jmain.clone(for_test=True)
        want, = jexe.run(infer, feed=feed, fetch_list=[jenc])
        for sub, pf in (("jax_files", None), ("jax_combined", "params")):
            jfluid.io.save_inference_model(str(root / sub), list(FEEDS),
                                           [jenc], jexe, jmain,
                                           params_filename=pf)
    weights = {v.name: np.array(jscope.find_var(v.name))
               for v in jmain.list_vars() if v.persistable}

    pmain, _, penc, _ = build_encoder(fluid, bert)
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, weights, CPU)
    pexe = fluid.Executor(CPU)
    with fluid.scope_guard(pscope):
        for sub, pf in (("port_files", None), ("port_combined", "params")):
            fluid.io.save_inference_model(str(root / sub), list(FEEDS),
                                          [penc], pexe, pmain,
                                          params_filename=pf)
    return dict(root=root, feed=feed, want=np.asarray(want), cfg=cfg,
                weights=weights, pmain=pmain, penc=penc)


@pytest.mark.parametrize("sub", ["jax_files", "jax_combined"])
def test_jax_export_serves_in_the_port(exports, sub):
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(
            str(exports["root"] / sub), exe)
    assert feeds == list(FEEDS) and len(fetches) == 1
    assert "feed" not in [op.type for op in prog.global_block().ops]
    # every weight arrives bit for bit
    for n, w in exports["weights"].items():
        if scope.find_var(n) is not None:
            np.testing.assert_array_equal(scope.find_var_numpy(n), w)
    got, = exe.run(prog, feed=exports["feed"], fetch_list=fetches,
                   scope=scope)
    assert_encoder_close(got, exports["want"], exports["feed"])


@pytest.mark.parametrize("sub", ["port_files", "port_combined"])
def test_port_export_serves_in_jax(exports, sub):
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        prog, feeds, fetches = jfluid.io.load_inference_model(
            str(exports["root"] / sub), jexe)
        got, = jexe.run(prog, feed=exports["feed"], fetch_list=fetches)
    assert feeds == list(FEEDS)
    # the same program and weights in JAX: equal bits
    np.testing.assert_array_equal(np.asarray(got), exports["want"])


@pytest.mark.parametrize("layout", ["files", "combined"])
def test_both_packages_export_the_same_bytes(exports, layout):
    jdir = exports["root"] / ("jax_" + layout)
    pdir = exports["root"] / ("port_" + layout)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    assert "__model__" in names and "__params_order__" in names
    for n in names:
        assert (pdir / n).read_bytes() == (jdir / n).read_bytes(), n


def _state_program(shapes):
    prog = fluid.Program()
    for name, shape, dt in shapes:
        prog.global_block().create_var(name=name, shape=shape, dtype=dt,
                                       persistable=True)
    return prog


SHAPES = (("fc_0.w_0", (4, 3), "float32"), ("fc_0.b_0", (3,), "float32"),
          ("emb", (5, 2), "bfloat16"), ("counter", (1,), "int64"))


def _fill(scope, seed):
    rng = np.random.RandomState(seed)
    vals = {}
    for name, shape, dt in SHAPES:
        if dt == "int64":
            t = torch.from_numpy(rng.randint(0, 99, shape))
        else:
            t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
                getattr(torch, dt))
        scope.set_var(name, t)
        vals[name] = t.clone()
    return vals


def _assert_scope(scope, vals):
    for n, t in vals.items():
        got = scope.find_var(n)
        assert got.dtype == t.dtype, n
        assert torch.equal(got, t), n


@pytest.mark.parametrize("filename", [None, "all"])
def test_save_load_persistables_round_trip_keeps_bits(tmp_path, filename):
    prog = _state_program(SHAPES)
    scope = fluid.Scope()
    vals = _fill(scope, 1)
    exe = fluid.Executor(CPU)
    d = str(tmp_path / "vars")
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, d, main_program=prog,
                                   filename=filename)
    if filename is None:
        # the bf16 file is the JAX package's: descr '<V2'
        head = open(os.path.join(d, "emb.npy"), "rb").read(80)
        assert b"'descr': '<V2'" in head
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        fluid.io.load_persistables(exe, d, main_program=prog,
                                   filename=filename)
    _assert_scope(fresh, vals)


def test_strict_load_names_the_missing_variable(tmp_path):
    prog = _state_program(SHAPES)
    scope = fluid.Scope()
    _fill(scope, 2)
    exe = fluid.Executor(CPU)
    d = str(tmp_path / "vars")
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, d, main_program=prog)
        fluid.io.save_vars(exe, str(tmp_path / "npz"), main_program=prog,
                           vars=[prog.global_block().var("fc_0.w_0")],
                           filename="all")
    os.remove(os.path.join(d, "fc_0.b_0.npy"))
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        with pytest.raises(RuntimeError) as ei:
            fluid.io.load_persistables(exe, d, main_program=prog)
        assert "fc_0.b_0" in str(ei.value) and d in str(ei.value)
        assert fresh.var_names() == []      # nothing half-loaded
        with pytest.raises(RuntimeError, match="fc_0.b_0"):
            fluid.io.load_persistables(exe, str(tmp_path / "npz"),
                                       main_program=prog, filename="all")
        fluid.io.load_persistables(exe, d, main_program=prog, strict=False)
        assert fresh.find_var("fc_0.b_0") is None
        assert fresh.find_var("fc_0.w_0") is not None


def test_load_without_executor_uses_the_held_device(tmp_path):
    prog = _state_program(SHAPES)
    scope = fluid.Scope()
    vals = _fill(scope, 3)
    d = str(tmp_path / "vars")
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(None, d, main_program=prog)
        for n in vals:
            scope.set_var(n, torch.zeros_like(vals[n]))
        fluid.io.load_persistables(None, d, main_program=prog)
    _assert_scope(scope, vals)
    if not torch.cuda.is_available():
        # nothing held and no executor: the card, which is not here
        with fluid.scope_guard(fluid.Scope()):
            with pytest.raises(RuntimeError, match="CUDA"):
                fluid.io.load_persistables(None, d, main_program=prog)


def _int64_in_jax_layout(tmp_path):
    """paddle_tpu holds a declared int64 variable as int32 and saves it
    so; the port widens it back on load."""
    d = tmp_path / "narrow"
    d.mkdir()
    np.save(str(d / "counter.npy"), np.array([41], np.int32))
    return str(d)


def test_int32_value_of_an_int64_variable_is_widened(tmp_path):
    d = _int64_in_jax_layout(tmp_path)
    prog = _state_program([("counter", (1,), "int64")])
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(fluid.Executor(CPU), d,
                                   main_program=prog)
    got = scope.find_var("counter")
    assert got.dtype == torch.int64 and got.tolist() == [41]


@pytest.mark.parametrize("params_filename", [None, "params"])
def test_kill_at_every_export_write_keeps_the_old_model(exports, tmp_path,
                                                        params_filename):
    pmain, penc = exports["pmain"], exports["penc"]
    pscope = fluid.Scope()
    fluid.load_numpy_params(pscope, exports["weights"], CPU)
    exe = fluid.Executor(CPU)

    def export(d):
        with fluid.scope_guard(pscope):
            fluid.io.save_inference_model(d, list(FEEDS), [penc], exe,
                                          pmain,
                                          params_filename=params_filename)

    with record_points() as points:
        export(str(tmp_path / "probe" / "model"))   # same point names
    assert any(p.startswith("model:") for p in points)
    assert any(p.startswith("before_commit:") for p in points)
    d = str(tmp_path / "model")
    export(d)
    before = {n: open(os.path.join(d, n), "rb").read()
              for n in os.listdir(d)}
    # the next export carries other weights, so a torn mix would show
    w = pmain.global_block().all_parameters()[-1].name
    real = pscope.find_var(w)
    pscope.set_var(w, real + 1.0)
    for point in points:
        with crash_at(point):
            with pytest.raises(SimulatedCrash):
                export(d)
        now = {n: open(os.path.join(d, n), "rb").read()
               for n in os.listdir(d)}
        if point.startswith("after_commit:"):
            assert now != before, point
            export(d)
            pscope.set_var(w, real)
            export(d)
            pscope.set_var(w, real + 1.0)
        else:
            assert now == before, point
    pscope.set_var(w, real)
    for junk in glob.glob(d + ".tmp-*"):
        assert os.path.isdir(junk)        # reader-invisible debris
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh):
        prog, _, fetches = fluid.io.load_inference_model(d, exe)
    got, = exe.run(prog, feed=exports["feed"], fetch_list=fetches,
                   scope=fresh)
    assert_encoder_close(got, exports["want"], exports["feed"])


def test_io_ops_in_a_program_keep_bits(tmp_path):
    """Checkpointing as a PROGRAM of save/load ops (the reference's
    save_op.cc / load_combine_op.cc contract), bf16 included."""
    shapes = SHAPES[:3]
    path = str(tmp_path / "ckpt")

    def prog_with(op, slot):
        p = _state_program(shapes)
        names = [n for n, _, _ in shapes]
        p.global_block().append_op(
            op, inputs={"X": names} if slot == "X" else {},
            outputs={"Out": names} if slot == "Out" else {"Out": []},
            attrs={"file_path": path})
        return p

    exe = fluid.Executor(CPU)
    sc = fluid.Scope()
    rng = np.random.RandomState(4)
    vals = {}
    for n, shape, dt in shapes:
        vals[n] = torch.from_numpy(rng.randn(*shape).astype(
            np.float32)).to(getattr(torch, dt))
        sc.set_var(n, vals[n])
    exe.run(prog_with("save_combine", "X"), scope=sc)
    assert os.path.exists(path + ".npz")
    for n in vals:
        sc.set_var(n, torch.zeros_like(vals[n]))
    exe.run(prog_with("load_combine", "Out"), scope=sc)
    _assert_scope(sc, vals)

    solo = str(tmp_path / "solo.npy")
    for n, shape, dt in shapes:
        sp = _state_program([(n, shape, dt)])
        sp.global_block().append_op("save", inputs={"X": [n]},
                                    outputs={"Out": []},
                                    attrs={"file_path": solo})
        lp = _state_program([(n, shape, dt)])
        lp.global_block().append_op("load", inputs={},
                                    outputs={"Out": [n]},
                                    attrs={"file_path": solo})
        exe.run(sp, scope=sc)
        sc.set_var(n, torch.zeros_like(vals[n]))
        exe.run(lp, scope=sc)
        assert torch.equal(sc.find_var(n), vals[n]), n
    assert not glob.glob(str(tmp_path / "*.tmp-*"))


def test_io_ops_read_reference_lod_tensor_files(tmp_path):
    rng = np.random.RandomState(5)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    with open(str(tmp_path / "w_ref"), "wb") as f:
        proto_compat.write_lod_tensor(f, w)
    with open(str(tmp_path / "both_ref"), "wb") as f:
        proto_compat.write_combined(f, [w, b])
    exe = fluid.Executor(CPU)
    sc = fluid.Scope()
    lp = _state_program([("pw", (4, 3), "float32")])
    lp.global_block().append_op("load", inputs={}, outputs={"Out": ["pw"]},
                                attrs={"file_path": str(tmp_path / "w_ref")})
    exe.run(lp, scope=sc)
    np.testing.assert_array_equal(sc.find_var_numpy("pw"), w)
    lc = _state_program([("pw", (4, 3), "float32"),
                         ("pb", (3,), "float32")])
    lc.global_block().append_op(
        "load_combine", inputs={}, outputs={"Out": ["pw", "pb"]},
        attrs={"file_path": str(tmp_path / "both_ref")})
    sc2 = fluid.Scope()
    exe.run(lc, scope=sc2)
    np.testing.assert_array_equal(sc2.find_var_numpy("pw"), w)
    np.testing.assert_array_equal(sc2.find_var_numpy("pb"), b)


def _convnet(pkg, train=True):
    img = pkg.layers.data(name="img", shape=[1, 12, 12], dtype="float32")
    conv = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
    bn = pkg.layers.batch_norm(conv, act="relu")
    pool = pkg.layers.pool2d(bn, pool_size=2, pool_stride=2)
    logits = pkg.layers.fc(input=pool, size=3)
    prob = pkg.layers.softmax(logits)
    if train:
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return img, prob


def test_prune_program_drops_training_ops():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img, prob = _convnet(fluid)
    pruned = fluid.io.prune_program(main, ["img"], [prob.name])
    types = [op.type for op in pruned.global_block().ops]
    assert "sgd" not in types and not any(t.endswith("_grad") for t in types)
    assert "conv2d" in types and "batch_norm" in types
    assert pruned._is_test
    assert all(op.attr("is_test") for op in pruned.global_block().ops
               if op.has_attr("is_test"))


def test_order_manifest_records_and_sets_feed_order(tmp_path):
    """Every export (combined AND per-file params) writes the order
    manifest with the feed/fetch order; loaders hand positional consumers
    the SAVED order, and a combined-params dir loads without the caller
    naming params_filename."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        z = fluid.layers.data(name="zz", shape=[4], dtype="float32")
        a = fluid.layers.data(name="aa", shape=[3], dtype="float32")
        out = fluid.layers.elementwise_add(fluid.layers.fc(z, size=3), a)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    rng = np.random.RandomState(0)
    zv, av = (rng.randn(2, 4).astype(np.float32),
              rng.randn(2, 3).astype(np.float32))
    with fluid.scope_guard(scope):
        exe.run(startup)
        for params_filename, sub in ((None, "per_file"),
                                     ("params", "combined")):
            d = str(tmp_path / sub)
            # deliberately NOT alphabetical: zz before aa
            fluid.io.save_inference_model(d, ["zz", "aa"], [out], exe,
                                          main,
                                          params_filename=params_filename)
            manifest = json.load(open(os.path.join(d, "__params_order__")))
            assert manifest["feed_order"] == ["zz", "aa"]
            assert manifest["fetch_order"] == [out.name]
            assert manifest["params_file"] == params_filename
        want, = exe.run(fluid.io.prune_program(main, ["zz", "aa"],
                                               [out.name]),
                        feed={"zz": zv, "aa": av}, fetch_list=[out.name])
    for sub in ("per_file", "combined"):
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            prog, feed_names, fetch_vars = fluid.io.load_inference_model(
                str(tmp_path / sub), exe)
        assert feed_names == ["zz", "aa"], sub
        got, = exe.run(prog, feed={"zz": zv, "aa": av},
                       fetch_list=fetch_vars, scope=fresh)
        np.testing.assert_array_equal(got, want)
    # a manifest naming other feeds means mixed artifacts: refused
    mpath = str(tmp_path / "per_file" / "__params_order__")
    m = json.load(open(mpath))
    m["feed_order"] = ["zz", "other"]
    json.dump(m, open(mpath, "w"))
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(ValueError, match="disagrees"):
            fluid.io.load_inference_model(str(tmp_path / "per_file"), exe)


def test_get_parameter_value_and_program_dict_round_trip():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _convnet(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(scope):
        exe.run(startup)
        p = main.global_block().all_parameters()[0]
        np.testing.assert_array_equal(
            fluid.io.get_parameter_value(p, exe), scope.find_var_numpy(p.name))
        with pytest.raises(TypeError):
            fluid.io.get_parameter_value(main.global_block().var("img"), exe)
    back = fluid.io.dict_to_program(fluid.io.program_to_dict(main))
    assert back.serialize_to_string() == main.serialize_to_string()
    with pytest.raises(RuntimeError, match="format version"):
        fluid.io.dict_to_program(dict(fluid.io.program_to_dict(main),
                                      version=99))
    # a program serializes the same after a pass through the pickle-era
    # dict format and through the ProgramDesc bytes
    again = fluid.Program.parse_from_string(main.serialize_to_string())
    buf = io.BytesIO(again.serialize_to_string())
    assert buf.getvalue() == main.serialize_to_string()
