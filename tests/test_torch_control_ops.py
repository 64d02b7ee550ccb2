"""The comparison, logical, modulo and ``isfinite`` ops, ``increment``
and ``conditional_block`` in the port (paddle_tpu_torch), each against
paddle_tpu on the CPU:

- each comparison and logical op on seeded numpy operands (ties
  included, and a broadcast ``[1]`` operand): the same bools exactly;
- ``elementwise_mod`` and ``elementwise_floordiv`` on float32 and int32
  operands of both signs: float32 ``rtol 1e-6, atol 1e-6``, int32
  exactly (the remainder takes the divisor's sign, as ``jnp.mod``);
- ``isfinite`` over three inputs, all finite, one inf, one NaN: the same
  ``(1,)`` bool;
- ``increment`` in place and not, and the layers of both packages
  emitting the same ops;
- ``conditional_block`` taken and not taken, on an Out with a previous
  value (a persistable) and Outs without one (shape declared, and shape
  only known by running the block): the same values exactly, zeros
  where a not-taken Out had none, and the persistable reaching the
  scope; the predicate's read-back counted as a host sync on the card
  only.  Its gradient, ``conditional_block_grad``, is held against
  paddle_tpu in tests/test_torch_control_flow.py.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as fluid
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

PKGS = (jfluid, fluid)


def _run(pkg, main, startup, feed, fetch, scope=None):
    scope = scope if scope is not None else pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    if startup is not None:
        exe.run(startup, scope=scope)
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return [np.asarray(g) for g in got], scope


def _binary_program(pkg, op_type, dtype, y_shape):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [3, 4], dtype=dtype,
                            append_batch_size=False)
        y = pkg.layers.data("y", y_shape, dtype=dtype,
                            append_batch_size=False)
        helper = pkg.layer_helper.LayerHelper(op_type)
        out = helper.create_variable_for_type_inference("bool")
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]})
    return main, startup, out


@pytest.mark.parametrize("y_shape", [[3, 4], [1]])
@pytest.mark.parametrize("op_type", [
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor"])
def test_comparison_and_logical_ops_match_jax(op_type, y_shape):
    rng = np.random.RandomState(0)
    if op_type.startswith("logical"):
        dtype = "bool"
        x = rng.rand(3, 4) > 0.5
        y = rng.rand(*y_shape) > 0.5
    else:
        dtype = "float32"
        x = rng.randint(-2, 3, (3, 4)).astype(np.float32)
        y = rng.randint(-2, 3, y_shape).astype(np.float32)
    got = {}
    for pkg in PKGS:
        main, startup, out = _binary_program(pkg, op_type, dtype, y_shape)
        got[pkg], _ = _run(pkg, main, startup, {"x": x, "y": y}, [out])
    assert got[fluid][0].dtype == np.bool_
    np.testing.assert_array_equal(got[fluid][0], got[jfluid][0])


def test_logical_not_and_the_layers_emit_jax_ops():
    def build(pkg):
        L = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            a = L.data("a", [4], dtype="float32", append_batch_size=False)
            b = L.data("b", [4], dtype="float32", append_batch_size=False)
            outs = [L.less_than(a, b), L.less_equal(a, b),
                    L.greater_than(a, b), L.greater_equal(a, b),
                    L.equal(a, b), L.not_equal(a, b)]
            outs.append(L.logical_not(L.logical_and(outs[0], outs[2])))
            outs.append(L.logical_or(outs[1], L.logical_xor(outs[4],
                                                            outs[5])))
            outs.append(L.elementwise_mod(a, b))
            outs.append(L.elementwise_floordiv(a, b))
            outs.append(L.elementwise_sub(a, b))
        return main, startup, outs

    feed = {"a": np.array([1, -2, 3, 0.5], np.float32),
            "b": np.array([1, 3, -2, 0.25], np.float32)}
    got, ops = {}, {}
    for pkg in PKGS:
        main, startup, outs = build(pkg)
        ops[pkg] = [(op.type, op.inputs, op.outputs, op.attrs)
                    for op in main.global_block().ops]
        got[pkg], _ = _run(pkg, main, startup, feed, outs)
    assert ops[fluid] == ops[jfluid]
    for a, b in zip(got[fluid], got[jfluid]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op_type", ["elementwise_mod",
                                     "elementwise_floordiv"])
def test_mod_and_floordiv_take_the_divisor_sign(op_type, dtype):
    """Negative dividends and divisors: 7 mod -3 = -2, -7 mod 3 = 2."""
    x = np.array([[7, -7, 7, -7], [5.5, -5.5, 0, 9]], dtype)
    y = np.array([[3, 3, -3, -3], [2, 2, 4, -4]], dtype)
    got = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            xv = pkg.layers.data("x", [2, 4], dtype=dtype,
                                 append_batch_size=False)
            yv = pkg.layers.data("y", [2, 4], dtype=dtype,
                                 append_batch_size=False)
            out = getattr(pkg.layers, op_type)(xv, yv)
        got[pkg], _ = _run(pkg, main, startup, {"x": x, "y": y}, [out])
    if op_type == "elementwise_mod" and dtype == "float32":
        np.testing.assert_allclose(got[fluid][0][0], [1, 2, -2, -1])
    if dtype == "int32":
        np.testing.assert_array_equal(got[fluid][0], got[jfluid][0])
    else:
        np.testing.assert_allclose(got[fluid][0], got[jfluid][0],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
def test_isfinite_over_several_inputs(poison):
    rng = np.random.RandomState(1)
    arrays = [rng.randn(2, 3).astype(np.float32) for _ in range(3)]
    if poison is not None:
        arrays[1][1, 2] = poison
    feed = {"x%d" % i: a for i, a in enumerate(arrays)}
    got = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            xs = [pkg.layers.data(n, [2, 3], append_batch_size=False)
                  for n in feed]
            helper = pkg.layer_helper.LayerHelper("isfinite")
            out = helper.create_variable_for_type_inference("bool")
            helper.append_op("isfinite", inputs={"X": xs},
                             outputs={"Out": [out]})
            single = pkg.layers.isfinite(xs[1])
        got[pkg], _ = _run(pkg, main, startup, feed, [out, single])
    for a, b in zip(got[fluid], got[jfluid]):
        assert a.shape == (1,) and a.dtype == np.bool_
        np.testing.assert_array_equal(a, b)
    assert bool(got[fluid][0][0]) == (poison is None)


def test_increment_in_place_and_not():
    got = {}
    for pkg in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            helper = pkg.layer_helper.LayerHelper("cnt")
            cnt = helper.create_global_variable(
                name="cnt", shape=(1,), dtype="float32", persistable=True)
            helper.set_variable_initializer(
                cnt, pkg.initializer.ConstantInitializer(2.0))
            out = pkg.layers.increment(cnt, 1.5, in_place=False)
            pkg.layers.increment(cnt, 0.5)
        scope = pkg.Scope()
        got[pkg] = []
        for _ in range(2):
            vals, scope = _run(pkg, main, startup if not got[pkg] else None,
                               {}, [out, cnt], scope)
            got[pkg].append(vals)
    for a, b in zip(got[fluid], got[jfluid]):
        np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
    np.testing.assert_array_equal(np.concatenate(got[fluid][1]), [4.0, 3.0])


def _cond_program(pkg):
    """flag > 0 gates a block that adds x to the persistable ``acc`` and
    writes ``fixed`` (shape declared) and ``free`` (batch dim -1), which
    have no value before the block."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = L.data("x", [4], dtype="float32")
        flag = L.data("flag", [1], dtype="float32", append_batch_size=False)
        helper = pkg.layer_helper.LayerHelper("acc")
        acc = helper.create_global_variable(
            name="acc", shape=(4,), dtype="float32", persistable=True)
        helper.set_variable_initializer(
            acc, pkg.initializer.ConstantInitializer(1.0))
        gb = main.global_block()
        fixed = gb.create_var(name="fixed", shape=(2, 3), dtype="float32")
        free = gb.create_var(name="free", shape=(-1, 4), dtype="float32")
        zero = L.fill_constant([1], "float32", 0.0)
        pred = L.greater_than(flag, zero)
        cb = L.control_flow.ConditionalBlock([pred])
        with cb.block():
            s = L.reduce_sum(x, dim=0)
            L.assign(L.elementwise_add(acc, s), acc)
            L.assign(L.fill_constant([2, 3], "float32", 7.0), fixed)
            L.assign(L.scale(x, scale=2.0), free)
    return main, startup, acc


@pytest.mark.parametrize("taken", [True, False])
def test_conditional_block_taken_and_not(taken):
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(5, 4).astype(np.float32),
            "flag": np.array([1.0 if taken else -1.0], np.float32)}
    got, ops = {}, {}
    for pkg in PKGS:
        main, startup, acc = _cond_program(pkg)
        ops[pkg] = [(op.type, op.inputs, op.outputs, op.attrs)
                    for b in main.blocks for op in b.ops]
        got[pkg], scope = _run(pkg, main, startup, feed,
                               ["fixed", "free", acc])
        if pkg is fluid:
            after = scope.find_var_numpy("acc")
    assert ops[fluid] == ops[jfluid]
    cb = [op for op in main.global_block().ops
          if op.type == "conditional_block"][0]
    assert sorted(cb.output("Out")) == ["acc", "fixed", "free"]
    for a, b in zip(got[fluid], got[jfluid]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if taken:
        np.testing.assert_allclose(after, 1.0 + feed["x"].sum(0),
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(after, np.ones(4, np.float32))
        np.testing.assert_array_equal(got[fluid][0], np.zeros((2, 3)))
        np.testing.assert_array_equal(got[fluid][1], np.zeros((5, 4)))


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device (the predicate's read-back
    path, which runs on the card only)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_conditional_block_counts_its_predicate_read_on_the_card_only():
    from paddle_tpu_torch.fluid.ops.control_flow_ops import _read_predicate
    main, startup, acc = _cond_program(fluid)
    feed = {"x": np.ones((2, 4), np.float32),
            "flag": np.array([1.0], np.float32)}
    before = fluid.profiler.host_sync_count("conditional_block")
    _run(fluid, main, startup, feed, [acc])
    assert fluid.profiler.host_sync_count("conditional_block") == before
    card = torch.tensor(False).as_subclass(_OnTheCard)
    assert _read_predicate(card) is False
    assert fluid.profiler.host_sync_count("conditional_block") == before + 1
