"""Sub-blocks in the port (paddle_tpu_torch): ``Program._create_block``
and ``_rollback``, the executor's read analysis and temporary release
across a control-flow op's step block, and the round trips of a
``StaticRNN`` program (one ``recurrent`` op whose ``sub_block`` attr
names block 1): ``clone(for_test=True)``, ``save_inference_model`` /
``load_inference_model`` (also of a model that paddle_tpu exported), and
``proto_compat`` encode/decode, byte-identical to paddle_tpu's and
parsed across the packages.  Every loaded or decoded program runs and
gives the original's outputs exactly (the same rules on the same
tensors).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import proto_compat as jpc

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as port_executor
from paddle_tpu_torch.fluid import lowering
from paddle_tpu_torch.fluid import proto_compat as ppc
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

T, B, D, H = 4, 3, 2, 5


def _rnn_program(pkg):
    """x [T, B, D] time-major through a StaticRNN whose step is an fc of
    [x_t, h] with tanh; returns (main, startup, x, out)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data("x", [T, B, D], dtype="float32", append_batch_size=False)
        h0 = L.fill_constant([B, H], "float32", 0.25)
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc(L.concat([x_t, h], axis=-1), size=H, act="tanh")
            rnn.update_memory(h, nh)
            rnn.output(nh)
        out = L.reduce_sum(rnn(), dim=[0])
    return main, startup, x, out


def _feed():
    return {"x": np.random.RandomState(0).randn(T, B, D).astype(np.float32)}


def _run(prog, startup, fetch, feed, scope=None):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = scope or fluid.Scope()
    if startup is not None:
        exe.run(startup, scope=scope)
    return np.asarray(exe.run(prog, feed=feed, fetch_list=fetch,
                              scope=scope)[0]), scope


def _structure(prog):
    return [(b.idx, b.parent_idx,
             sorted((n, tuple(v.shape) if v.shape else None, v.dtype,
                     bool(v.persistable)) for n, v in b.vars.items()),
             [(op.type, op.inputs, op.outputs, op.attrs) for op in b.ops])
            for b in prog.blocks]


def test_create_block_and_rollback():
    prog = fluid.Program()
    sub = prog._create_block()
    assert prog.current_block() is sub and sub.parent_block is \
        prog.global_block()
    inner = prog._create_block()
    assert inner.parent_idx == sub.idx and inner.idx == 2
    prog._rollback()
    assert prog.current_block() is sub
    prog._rollback()
    assert prog.current_block_idx == 0
    v = prog.global_block().create_var(name="g", shape=(1,))
    assert inner.var("g") is v and not inner.has_var_local("g")


def test_static_rnn_builds_one_recurrent_op_over_block_1():
    main, _, _, _ = _rnn_program(fluid)
    rec = [op for op in main.global_block().ops if op.type == "recurrent"]
    assert len(rec) == 1 and len(main.blocks) == 2
    op = rec[0]
    assert op.attr("sub_block") == 1 and main.block(1).parent_idx == 0
    assert set(op.input("Params")) == {"fc_0.w_0", "fc_0.b_0"}
    assert [o.type for o in main.block(1).ops] == \
        ["concat", "mul", "elementwise_add", "tanh"]
    # the step block's ops never run at the top level
    assert "mul" not in [o.type for o in main.global_block().ops]


def test_read_analysis_and_release_see_the_step_block():
    """A var read only inside a step block is a read of the program, and
    the release plan keeps it alive until the control-flow op has run."""
    main, _, _, _ = _rnn_program(fluid)
    block = main.global_block()
    op = [o for o in block.ops if o.type == "recurrent"][0]
    op.inputs["Params"] = []          # as if the builder had not declared
    reads, _ = port_executor._block_reads_writes(block, ["x"])
    assert {"fc_0.w_0", "fc_0.b_0"} <= set(reads)
    assert not set(op.attr("step_input_vars")) & set(reads)
    idx = block.ops.index(op)
    h0 = op.input("Initials")[0]
    release = lowering.plan_release(block, set())
    freed_at = {n: i for i, ns in release.items() for n in ns}
    assert freed_at[h0] == idx
    assert freed_at["fc_0.w_0"] == idx


def test_clone_for_test_keeps_the_sub_block():
    main, startup, _, out = _rnn_program(fluid)
    test = main.clone(for_test=True)
    assert _structure(test) == _structure(main)
    want, scope = _run(main, startup, [out], _feed())
    got, _ = _run(test, None, [out], _feed(), scope)
    np.testing.assert_array_equal(got, want)


def test_proto_round_trip_matches_paddle_tpu_bytes():
    jmain = _rnn_program(jfluid)[0]
    pmain, startup, _, out = _rnn_program(fluid)
    pbytes = ppc.serialize_program(pmain)
    assert pbytes == jpc.serialize_program(jmain)
    decoded = fluid.Program.parse_from_string(pbytes)
    assert _structure(decoded) == _structure(jpc.parse_program(pbytes))
    assert ppc.serialize_program(decoded) == pbytes
    assert decoded.block(1).parent_idx == 0
    want, scope = _run(pmain, startup, [out], _feed())
    got, _ = _run(decoded, None, [out.name], _feed(), scope)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exporter", ["port", "paddle_tpu"])
def test_inference_model_round_trip(exporter, tmp_path):
    """Export the StaticRNN program (from the port, or from paddle_tpu
    with its startup weights), load it with the port's
    load_inference_model and run it: the outputs of the unexported
    program from the same weights."""
    pmain, pstartup, _, pout = _rnn_program(fluid)
    d = str(tmp_path / "rnn")
    if exporter == "port":
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(pstartup, scope=scope)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["x"], [pout], exe,
                                          main_program=pmain)
    else:
        jmain, jstartup, _, jout = _rnn_program(jfluid)
        jscope = jfluid.Scope()
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup, scope=jscope)
        with jfluid.scope_guard(jscope):
            jfluid.io.save_inference_model(d, ["x"], [jout], jexe,
                                           main_program=jmain)
        scope = fluid.Scope()
        fluid.load_numpy_params(scope, {
            n: np.array(jscope.find_var(n)) for n in
            ("fc_0.w_0", "fc_0.b_0")}, fluid.CPUPlace())
    want, _ = _run(pmain, None, [pout], _feed(), scope)
    load_scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(load_scope):
        prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
    assert feeds == ["x"] and len(prog.blocks) == 2
    assert [o.type for o in prog.global_block().ops].count("recurrent") == 1
    got = np.asarray(exe.run(prog, feed=_feed(), fetch_list=fetches,
                             scope=load_scope)[0])
    np.testing.assert_array_equal(got, want)
