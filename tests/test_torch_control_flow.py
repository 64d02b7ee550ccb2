"""Control flow and the LoD array ops in the port (paddle_tpu_torch),
each program run through both packages on the CPU with the same numpy
feeds: integers exactly, floats within 1e-6.

- the programs of tests/test_control_flow.py: ``While`` counting and
  accumulating, ``While`` filling a tensor array, ``cond`` in both
  branches and with an outer write, ``Switch`` first match, ``IfElse``
  merging by the mask;
- the programs of tests/test_lod_machinery.py: the rank table and
  ``max_sequence_len``, the LoD tensor / array round trip with
  ``reorder_lod_tensor_by_rank``, ``shrink_rnn_memory`` with
  ``rnn_memory_helper``, ``split_lod_tensor`` / ``merge_lod_tensor``;
- the op lists the layers emit, against JAX's;
- the branch gradients: ``conditional_block_grad`` taken (0.5: 3/8
  through the branch, 1/8 through the ``assign`` it overwrote) and not
  taken (0.125), ``cond_grad`` (2.0, and 0.25 in the false branch);
- a tensor array written past its capacity (the length 7, the row at
  the last index), ``print`` and the ``while`` predicate's host sync.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

PKGS = (jfluid, fluid)


def _run(pkg, main, startup, feed, fetch):
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch, scope=scope)]


def _both(build, feed=None):
    """Build with each package and run; returns {pkg: [fetches]} and the
    main programs."""
    got, mains = {}, {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        got[pkg] = _run(pkg, main, startup, feed or {}, fetch)
        mains[pkg] = main
    return got, mains


def _same(got):
    for a, b in zip(got[fluid], got[jfluid]):
        assert a.shape == b.shape, (a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            # the port keeps int64 where JAX without x64 narrows to int32
            assert a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)


def _op_types(main):
    return [[op.type for op in blk.ops] for blk in main.blocks]


# ---------------------------------------------------------------------------
# tests/test_control_flow.py's programs
# ---------------------------------------------------------------------------

def _while_acc(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=10)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        one = L.fill_constant(shape=[1], dtype="float32", value=2.0)
        L.assign(acc + one, output=acc)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    return [i, acc]


def _while_array(pkg):
    L = pkg.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=5)
    arr = L.create_array("float32", max_len=8)
    x = L.fill_constant(shape=[3], dtype="float32", value=1.0)
    cond = L.less_than(x=i, y=limit)
    w = L.While(cond=cond)
    with w.block():
        fi = L.cast(i, "float32")
        L.array_write(x * fi, i, array=arr)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    stacked = L.tensor.create_tensor("float32")
    n = L.array_length(arr)
    pkg.default_main_program().current_block().append_op(
        "tensor_array_to_tensor", inputs={"X": [arr]},
        outputs={"Out": [stacked], "OutIndex": []},
        attrs={"axis": 0, "use_stack": True})
    return [stacked, n]


def test_while_counts_and_accumulates():
    got, mains = _both(_while_acc)
    _same(got)
    assert int(got[fluid][0][0]) == 10
    np.testing.assert_allclose(got[fluid][1], [20.0], rtol=1e-6)
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


def test_while_fills_a_tensor_array():
    got, mains = _both(_while_array)
    _same(got)
    out, n = got[fluid]
    assert int(n[0]) == 5
    np.testing.assert_allclose(out[:5], np.arange(5, dtype=np.float32)[
        :, None] * np.ones((5, 3), np.float32), rtol=1e-6)
    np.testing.assert_array_equal(out[5:], 0.0)
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


@pytest.mark.parametrize("flag,expect", [(1.0, 14.0), (0.0, 3.75)])
def test_cond_layer_both_branches(flag, expect):
    def build(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[4], dtype="float32",
                   append_batch_size=False)
        pred_v = L.fill_constant(shape=[1], dtype="float32", value=flag)
        half = L.fill_constant(shape=[1], dtype="float32", value=0.5)
        pred = L.greater_than(pred_v, half)
        return [L.cond(pred, lambda: L.reduce_sum(x * 2.0),
                       lambda: L.reduce_mean(x + 2.0))]
    got, mains = _both(build, {"x": np.array([1, 2, 3, 1], np.float32)})
    _same(got)
    np.testing.assert_allclose(got[fluid][0], expect, rtol=1e-6)
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


def test_cond_propagates_outer_writes():
    def build(pkg):
        L = pkg.layers
        lr = L.tensor.create_global_var(shape=[1], value=1.0,
                                        dtype="float32", persistable=True,
                                        name="cond_lr")
        L.assign(L.fill_constant([1], "float32", 1.0), output=lr)
        one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
        zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        pred = L.greater_than(one, zero)

        def true_fn():
            L.assign(L.fill_constant([1], "float32", 42.0), output=lr)

        L.cond(pred, true_fn, lambda: None)
        return [lr]
    got, mains = _both(build)
    _same(got)
    np.testing.assert_allclose(got[fluid][0], [42.0], rtol=1e-6)
    cond_op = [op for op in mains[fluid].global_block().ops
               if op.type == "cond"][0]
    assert cond_op.output("Out") == ["cond_lr"]


@pytest.mark.parametrize("step_val,expect",
                         [(0.0, 0.1), (5.0, 0.2), (50.0, 0.3)])
def test_switch_first_match_wins(step_val, expect):
    def build(pkg):
        L = pkg.layers
        step = L.fill_constant(shape=[1], dtype="float32", value=step_val)
        lr = L.tensor.create_global_var(shape=[1], value=0.0,
                                        dtype="float32", persistable=True,
                                        name="sw_lr")
        b1 = L.fill_constant(shape=[1], dtype="float32", value=1.0)
        b2 = L.fill_constant(shape=[1], dtype="float32", value=10.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(step, b1)):
                L.assign(L.fill_constant(shape=[1], dtype="float32",
                                         value=0.1), output=lr)
            with switch.case(L.less_than(step, b2)):
                L.assign(L.fill_constant(shape=[1], dtype="float32",
                                         value=0.2), output=lr)
            with switch.default():
                L.assign(L.fill_constant(shape=[1], dtype="float32",
                                         value=0.3), output=lr)
        return [lr]
    got, mains = _both(build)
    _same(got)
    np.testing.assert_allclose(got[fluid][0], [expect], rtol=1e-6)
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


def test_ifelse_merges_by_mask():
    def build(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[1], dtype="float32")
        zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.greater_than(x, zero)
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(x * 2.0)
        with ie.false_block():
            ie.output(x - 1.0)
        return [ie()]
    xv = np.array([[1.0], [-2.0], [3.0]], np.float32)
    got, mains = _both(build, {"x": xv})
    _same(got)
    np.testing.assert_allclose(got[fluid][0],
                               np.where(xv > 0, xv * 2, xv - 1), rtol=1e-6)
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


def test_layers_emit_jax_ops():
    """Print, the array layers, is_empty and reorder_lod_tensor_by_rank
    emit the JAX layers' ops, slots and attrs."""
    def build(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        arr = L.array_write(x, i)
        r = L.array_read(arr, i)
        n = L.array_length(arr)
        p = L.Print(r, message="r: ")
        e = L.is_empty(x)
        table = L.tensor.create_tensor("int32")
        o = L.reorder_lod_tensor_by_rank(x, table)
        return [p, n, e, o]
    progs = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            build(pkg)
        progs[pkg] = [(op.type, sorted(op.inputs), sorted(op.outputs),
                       sorted((k, v) for k, v in op.attrs.items()
                              if not k.startswith("__")))
                      for op in main.global_block().ops]
    assert progs[fluid] == progs[jfluid]


# ---------------------------------------------------------------------------
# tests/test_lod_machinery.py's programs
# ---------------------------------------------------------------------------

def _run_ops(pkg, op_specs, feeds, fetch):
    """A raw op-list program (op_specs: (type, ins, outs, attrs)), run."""
    main, startup = pkg.Program(), pkg.Program()
    block = main.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=np.asarray(arr).shape,
                         dtype=str(np.asarray(arr).dtype), is_data=True)
    created = set(feeds)
    for tp, ins, outs, attrs in op_specs:
        for names in outs.values():
            for n in names:
                if n not in created:
                    block.create_var(name=n)
                    created.add(n)
        block.append_op(tp, inputs=ins, outputs=outs, attrs=attrs)
    return _run(pkg, main, startup, feeds, fetch)


def _both_ops(op_specs, feeds, fetch):
    got = {pkg: _run_ops(pkg, op_specs, feeds, fetch) for pkg in PKGS}
    _same(got)
    return got[fluid]


def test_lod_rank_table_and_max_len():
    table, mx = _both_ops(
        [("lod_rank_table", {"X": ["x"], "Length": ["l"]},
          {"Out": ["t"]}, {}),
         ("max_sequence_len", {"RankTable": ["t"]}, {"Out": ["m"]}, {})],
        {"x": np.zeros((3, 5, 2), np.float32),
         "l": np.array([2, 5, 3], np.int64)}, ["t", "m"])
    np.testing.assert_array_equal(table[:, 0], [1, 2, 0])
    np.testing.assert_array_equal(table[:, 1], [5, 3, 2])
    assert mx[0] == 5


def test_lod_tensor_array_round_trip():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 4, 2).astype(np.float32)
    ln = np.array([4, 2, 3], np.int64)
    for b, n in enumerate(ln):
        x[b, n:] = 0
    back, reord = _both_ops(
        [("lod_rank_table", {"X": ["x"], "Length": ["l"]},
          {"Out": ["t"]}, {}),
         ("lod_tensor_to_array", {"X": ["x"], "RankTable": ["t"]},
          {"Out": ["arr"]}, {}),
         ("array_to_lod_tensor", {"X": ["arr"], "RankTable": ["t"]},
          {"Out": ["back"]}, {}),
         ("reorder_lod_tensor_by_rank", {"X": ["x"], "RankTable": ["t"]},
          {"Out": ["ro"]}, {})],
        {"x": x, "l": ln}, ["back", "ro"])
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(reord, x[[0, 2, 1]])


def test_lod_tensor_to_array_entries_and_length():
    """Entry t of lod_tensor_to_array is the step-t rows in rank order,
    zeros past a length (read back through tensor_array_to_tensor)."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 2).astype(np.float32)
    ln = np.array([1, 4, 2], np.int64)
    stacked, n = _both_ops(
        [("lod_rank_table", {"X": ["x"], "Length": ["l"]},
          {"Out": ["t"]}, {}),
         ("lod_tensor_to_array", {"X": ["x"], "RankTable": ["t"]},
          {"Out": ["arr"]}, {}),
         ("tensor_array_to_tensor", {"X": ["arr"]},
          {"Out": ["s"], "OutIndex": ["n"]}, {"axis": 0})],
        {"x": x, "l": ln}, ["s", "n"])
    assert stacked.shape == (4, 3, 2) and int(n[0]) == 4
    np.testing.assert_array_equal(stacked[:, 0], x[1])
    np.testing.assert_array_equal(stacked[2:, 1], 0.0)


def test_shrink_rnn_memory_and_helpers():
    x = np.arange(6, dtype=np.float32).reshape(3, 2) + 1
    out, h = _both_ops(
        [("lod_rank_table", {"X": ["x"], "Length": ["l"]},
          {"Out": ["t"]}, {}),
         ("shrink_rnn_memory",
          {"X": ["x"], "I": ["i"], "RankTable": ["t"]},
          {"Out": ["o"]}, {}),
         ("rnn_memory_helper", {"X": ["x"]}, {"Out": ["h"]}, {})],
        {"x": x, "l": np.array([3, 1, 2], np.int64),
         "i": np.array([1], np.int64)}, ["o", "h"])
    np.testing.assert_array_equal(out[0], x[0])
    np.testing.assert_array_equal(out[2], 0)
    np.testing.assert_array_equal(h, x)


def test_rnn_memory_helper_grad_passes_the_gradient():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    g = np.full((3, 2), 0.5, np.float32)
    dx, = _both_ops(
        [("rnn_memory_helper_grad", {"X": ["x"], "Out@GRAD": ["g"]},
          {"X@GRAD": ["dx"]}, {})],
        {"x": x, "g": g}, ["dx"])
    np.testing.assert_array_equal(dx, g)


def test_split_merge_lod_tensor():
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    t, f, merged = _both_ops(
        [("split_lod_tensor", {"X": ["x"], "Mask": ["m"]},
          {"OutTrue": ["t"], "OutFalse": ["f"]}, {}),
         ("merge_lod_tensor",
          {"InTrue": ["t"], "InFalse": ["f"], "Mask": ["m"], "X": ["x"]},
          {"Out": ["o"]}, {})],
        {"x": x, "m": np.array([[1], [0], [1], [0]], np.int32)},
        ["t", "f", "o"])
    np.testing.assert_array_equal(t[0], x[0])
    np.testing.assert_array_equal(t[1], 0)
    np.testing.assert_array_equal(f[1], x[1])
    np.testing.assert_array_equal(merged, x)


# ---------------------------------------------------------------------------
# Branch gradients, capacity, print, syncs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag,expect", [(1.0, 0.5), (-1.0, 0.125)])
def test_conditional_block_grad_matches_jax(flag, expect):
    """``out = assign(x)``, a ConditionalBlock assigning ``scale(x, 3)``
    to ``out``, ``dx = gradients(mean(out), [x])`` on ones [2, 4]: 3/8
    through the branch plus 1/8 through the overwritten assign when it
    is taken, the assign's 1/8 alone when not."""
    def build(pkg):
        L = pkg.layers
        main = pkg.default_main_program()
        x = L.data("x", [4], dtype="float32")
        x.stop_gradient = False
        out = main.global_block().create_var(name="out", shape=(-1, 4),
                                             dtype="float32")
        L.assign(x, out)
        pred = L.less_than(L.fill_constant([1], "float32", 0.0),
                           L.fill_constant([1], "float32", flag))
        cb = L.control_flow.ConditionalBlock([pred])
        with cb.block():
            L.assign(L.scale(x, scale=3.0), out)
        dx, = pkg.gradients(L.mean(out), [x])
        return [dx, out]
    got, mains = _both(build, {"x": np.ones((2, 4), np.float32)})
    _same(got)
    np.testing.assert_array_equal(got[fluid][0], np.full((2, 4), expect))
    types = _op_types(mains[fluid])[0]
    assert "conditional_block_grad" in types and "assign_grad" in types
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


@pytest.mark.parametrize("flag,expect", [(1.0, 2.0), (0.0, 0.25)])
def test_cond_grad_matches_jax(flag, expect):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4], dtype="float32", append_batch_size=False)
        x.stop_gradient = False
        pred = L.greater_than(L.fill_constant([1], "float32", flag),
                              L.fill_constant([1], "float32", 0.5))
        out = L.cond(pred, lambda: L.reduce_sum(x * 2.0),
                     lambda: L.reduce_mean(x + 2.0))
        dx, = pkg.gradients(out, [x])
        return [out, dx]
    got, mains = _both(build, {"x": np.array([1, 2, 3, 1], np.float32)})
    _same(got)
    np.testing.assert_array_equal(got[fluid][1], np.full(4, expect))
    assert "cond_grad" in _op_types(mains[fluid])[0]
    assert _op_types(mains[fluid]) == _op_types(mains[jfluid])


def test_array_write_past_capacity_clamps_the_row_not_the_length():
    def build(pkg):
        L = pkg.layers
        arr = L.create_array("float32", max_len=4)
        i = L.fill_constant([1], "int64", 6)
        L.array_write(L.fill_constant([3], "float32", 2.0), i, array=arr)
        n = L.array_length(arr)
        st = L.tensor.create_tensor("float32")
        pkg.default_main_program().current_block().append_op(
            "tensor_array_to_tensor", inputs={"X": [arr]},
            outputs={"Out": [st], "OutIndex": []},
            attrs={"axis": 0, "use_stack": True})
        r = L.array_read(arr, i)
        return [n, st, r]
    got, _ = _both(build)
    _same(got)
    n, st, r = got[fluid]
    assert n.dtype == np.int32 and int(n[0]) == 7
    np.testing.assert_array_equal(st[3], [2.0, 2.0, 2.0])
    np.testing.assert_array_equal(st[:3], 0.0)
    np.testing.assert_array_equal(r, [2.0, 2.0, 2.0])


def test_print_prints_and_passes_its_input(capsys):
    def build(pkg):
        x = pkg.layers.data("x", [2], dtype="float32",
                            append_batch_size=False)
        return [pkg.layers.Print(x, message="value: ")]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(fluid)
    got = _run(fluid, main, startup,
               {"x": np.array([1.5, -2.0], np.float32)}, fetch)
    np.testing.assert_array_equal(got[0], [1.5, -2.0])
    assert "value: [ 1.5 -2. ]" in capsys.readouterr().out


def test_while_output_without_an_init_raises_jax_text():
    def build(pkg):
        L = pkg.layers
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=2)
        cond = L.less_than(x=i, y=limit)
        late = pkg.default_main_program().global_block().create_var(
            name="late", shape=(1,), dtype="float32")
        w = L.While(cond=cond)
        with w.block():
            L.assign(L.fill_constant([1], "float32", 1.0), output=late)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [i]
    msgs = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        with pytest.raises(ValueError) as e:
            _run(pkg, main, startup, {}, fetch)
        msgs[pkg] = str(e.value).split("\n")[0]
    assert msgs[fluid] == msgs[jfluid]
    assert "have no value before the loop" in msgs[fluid]


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device (the read-back path, which
    runs on the card only)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_while_counts_one_predicate_read_per_check_on_the_card_only():
    from paddle_tpu_torch.fluid.ops.control_flow_ops import _read_predicate
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = _while_acc(fluid)
    before = fluid.profiler.host_sync_count("while")
    _run(fluid, main, startup, {}, fetch)
    assert fluid.profiler.host_sync_count("while") == before
    card = torch.tensor(True).as_subclass(_OnTheCard)
    assert _read_predicate(card, "while") is True
    assert fluid.profiler.host_sync_count("while") == before + 1
