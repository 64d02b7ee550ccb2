"""The 25 sequence, RNN and CTC op types of the port (paddle_tpu_torch),
each against paddle_tpu on the CPU on the same seeded numpy inputs:
sequence_softmax, sequence_reverse, sequence_expand_as, sequence_expand,
sequence_pad, sequence_unpad, sequence_concat, sequence_slice,
sequence_enumerate, gru, im2sequence, row_conv, lstm_unit, gru_unit,
warpctc, edit_distance, sequence_erase, sequence_reshape,
sequence_scatter, chunk_eval, add_position_encoding, ctc_align, lstmp,
cudnn_lstm and hierarchical_sigmoid.

The programs are ``chip_smoke.seq_programs()``, which the card's
``sequence_ops`` phase runs too: each builds its op in both packages
through the layer a user calls (a raw op for cudnn_lstm), every mode the
op has side by side in one program (gru's four of ``is_reverse`` x
``origin_mode``, both directions of lstmp, one and two bidirectional
layers of cudnn_lstm, the four chunk schemes), then ``mean(out * c)``
with a fixed random ``c`` and ``fluid.gradients`` for the float inputs
the op differentiates and its parameters (the same seeded values loaded
into both scopes).  Each test then checks a few values by hand.

Tolerances: float32 ``rtol 1e-5, atol 1e-6``; the recurrences (gru,
lstmp, cudnn_lstm) and warpctc, whose step sums run in another order
than ``lax.scan``'s, ``rtol 1e-4, atol 1e-5``; integer outputs, the edit
distances and chunk_eval's rates exactly (``chip_smoke.SEQ_TOL``).
"""

import numpy as np
import pytest

import chip_smoke
from chip_smoke import SEQ_LENS, seq_programs, seq_weights
from test_torch_book_ops import _both, _run
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid

PROGRAMS = seq_programs()


def _check(name):
    """Both packages' fetches of program ``name`` held at its
    tolerance; returns (the port's fetches, the feed)."""
    build, feed, seed, tol = PROGRAMS[name]
    rtol, atol = chip_smoke.SEQ_TOL[tol]
    init = seq_weights(build, seed) if seed is not None else None
    out, _ = _both(build, feed, rtol, atol, init=init)
    return out, feed


def test_every_op_type_has_a_program():
    assert len(PROGRAMS) == 25
    assert set(PROGRAMS) <= set(fluid.registry.OP_DEFS)


# -- the sequence ops of sequence_ops.py ------------------------------------

def test_sequence_softmax():
    """``[B, T]`` and ``[B, T, 1]`` inputs, one row empty."""
    (o2, o3, g2, g3), _ = _check("sequence_softmax")
    np.testing.assert_allclose(o2.sum(1), [1, 1, 1, 0], rtol=1e-6)
    assert (o2[1, 1:] == 0).all() and (g2[3] == 0).all()


def test_sequence_reverse():
    (out, _), feed = _check("sequence_reverse")
    x = feed["x"]
    np.testing.assert_array_equal(out[0, :5], x[0, 4::-1])
    np.testing.assert_array_equal(out[0, 5], x[0, 5])


def test_sequence_expand_as():
    (out, _), _ = _check("sequence_expand_as")
    assert out.shape == (4, 6, 3) and (out[1, 1:] == 0).all()


def test_sequence_expand():
    """Each row's ``length`` steps tiled over ``ref_length`` of 7."""
    (out, _), feed = _check("sequence_expand")
    np.testing.assert_array_equal(out[0, :5], feed["x"][0, [0, 1, 0, 1, 0]])
    assert (out[3, 2:] == 0).all()


def test_sequence_pad():
    """Flat-compact rows (capacity 12 for 9 valid) to ``[4, 6, 3]``,
    with the default zero and with a fed PadValue; Length comes back."""
    (o1, o2, _, l1), feed = _check("sequence_pad")
    np.testing.assert_array_equal(o1[2, :3], feed["x"][6:9])
    assert (o2[1, 1:] == -2.5).all()
    np.testing.assert_array_equal(l1, SEQ_LENS)


def test_sequence_unpad():
    (out, gx), feed = _check("sequence_unpad")
    x = feed["x"]
    np.testing.assert_array_equal(out[:9], np.concatenate(
        [x[0, :5], x[1, :1], x[2, :3]]))
    assert (out[9:] == 0).all() and (gx[0, 5] == 0).all()


def test_sequence_concat():
    (out, _, _, oln), feed = _check("sequence_concat")
    np.testing.assert_array_equal(oln, feed["la"] + feed["lb"])
    np.testing.assert_array_equal(out[3, :3], np.concatenate(
        [feed["a"][3, :1], feed["b"][3, :2]]))


def test_sequence_slice():
    (out, _), feed = _check("sequence_slice")
    np.testing.assert_array_equal(out[2, 0], feed["x"][2, 2])
    assert (out[2, 1:] == 0).all()


def test_sequence_enumerate():
    (out,), feed = _check("sequence_enumerate")
    ids = feed["ids"]
    np.testing.assert_array_equal(out[0, 3], [ids[0, 3], ids[0, 4], -1])
    assert (out[3] == -1).all()


# -- gru (rnn_ops.py) --------------------------------------------------------

def test_gru():
    """Forward, reversed, and both in ``origin_mode`` (the first two
    from an H0): Hidden, and the gradients of Input, H0 and every
    Weight and Bias; steps past a row's length are 0."""
    out, _ = _check("gru")
    for hidden in out[:4]:
        assert (hidden[1, 1:] == 0).all() and (hidden[3] == 0).all()
    assert not np.allclose(out[0], out[2])


# -- im2sequence (misc_ops.py) ------------------------------------------------

def test_im2sequence_feature_order():
    """A 3 x 2 window with strides (2, 1) and paddings up 1, left 0, down
    2, right 1: both packages agree, and so does a numpy unfold whose
    features run (C, kh, kw)."""
    (out, _), feed = _check("im2sequence")
    x = feed["x"]
    Ho, Wo = (7 + 3 - 3) // 2 + 1, (9 + 1 - 2) // 1 + 1
    xp = np.pad(x, ((0, 0), (0, 0), (1, 2), (0, 1)))
    want = np.stack([xp[:, :, 2 * i:2 * i + 3, j:j + 2].reshape(2, -1)
                     for i in range(Ho) for j in range(Wo)], axis=1)
    np.testing.assert_array_equal(out, want)


# -- misc_ops2.py -------------------------------------------------------------

def test_row_conv():
    (out, _, _), feed = _check("row_conv")
    assert out.shape == feed["x"].shape


def test_lstm_unit():
    """fc([x, h]) then the cell, forget_bias 1: H and C and the
    gradients of x, h, c and the fc's parameters.  The JAX layer calls a
    ``concat`` its ``nn`` module lacks, so the JAX side builds the
    layer's ops by hand (``concat``, ``fc``, the ``lstm_unit`` op)."""
    out, _ = _check("lstm_unit")
    assert out[0].shape == out[1].shape == (4, 5)


def test_gru_unit():
    """Default and ``origin_mode`` side by side: Hidden, ResetHiddenPrev,
    Gate and the gradients of Input, HiddenPrev, Weight and Bias."""
    out, feed = _check("gru_unit")
    np.testing.assert_allclose(out[1], out[2][:, 4:8] * feed["h"],
                               rtol=1e-6)


def test_warpctc():
    """Loss and the gradient of the logits, with and without
    ``norm_by_times``, over a repeated label, a short logit length and
    an empty label."""
    (loss, loss_n, _), feed = _check("warpctc")
    assert np.isfinite(loss).all() and (loss > 0).all()
    np.testing.assert_allclose(loss_n[:, 0], loss[:, 0] / feed["logit_len"],
                               rtol=1e-6)


def test_edit_distance():
    """Distances exact, plain and normalized, with SequenceNum, and equal
    to a numpy Levenshtein distance."""
    (d, dn, n), feed = _check("edit_distance")
    hyp, ref, hl, rl = feed["hyp"], feed["ref"], feed["hl"], feed["rl"]

    def lev(a, b):
        t = np.arange(len(b) + 1)
        for i, ai in enumerate(a):
            new = [i + 1]
            for j, bj in enumerate(b):
                new.append(min(new[-1] + 1, t[j + 1] + 1, t[j] + (ai != bj)))
            t = np.array(new)
        return t[-1]

    want = [lev(hyp[b, :hl[b]], ref[b, :rl[b]]) for b in range(len(hl))]
    np.testing.assert_array_equal(d[:, 0], want)
    assert int(n) == len(hl)


# -- misc_ops3.py -------------------------------------------------------------

def test_sequence_erase():
    (out, oln), _ = _check("sequence_erase")
    np.testing.assert_array_equal(oln, [3, 1, 2, 0])
    np.testing.assert_array_equal(out[0], [1, 3, 4, 0, 0, 0])


def test_sequence_reshape():
    (out, _, oln), _ = _check("sequence_reshape")
    assert out.shape == (4, 3, 8)
    np.testing.assert_array_equal(oln, SEQ_LENS // 2)


def test_sequence_scatter():
    """Repeated and negative ids within a row add up; padding adds 0."""
    (out, _, gu), feed = _check("sequence_scatter")
    x, upd = feed["x"], feed["upd"]
    assert out[0, 1] == pytest.approx(x[0, 1] + upd[0, 0] + upd[0, 1])
    assert out[2, 7] == pytest.approx(x[2, 7] + upd[2, 0])
    assert (gu[3] == 0).all()


def test_chunk_eval():
    """Precision, recall, F1 and the three counts under IOB, IOE, IOBES
    and plain, exactly."""
    out, _ = _check("chunk_eval")
    assert len(out) == 6 * len(chip_smoke.CHUNK_SCHEMES)
    assert all(int(out[6 * k + 3]) > 0
               for k in range(len(chip_smoke.CHUNK_SCHEMES)))


# -- misc_ops4.py -------------------------------------------------------------

def test_add_position_encoding():
    """sin in the first half of the features, cos in the second."""
    (out, _), feed = _check("add_position_encoding")
    x = feed["x"]
    np.testing.assert_allclose(out[0, 3, 0], 0.5 * x[0, 3, 0] +
                               2.0 * np.sin(3.0), rtol=1e-6)
    np.testing.assert_allclose(out[0, 3, 3], 0.5 * x[0, 3, 3] +
                               2.0 * np.cos(3.0), rtol=1e-6)


def test_add_position_encoding_refuses_an_odd_width():
    odd = np.zeros((2, 5, 5), np.float32)

    def build(pkg):
        return [pkg.layers.add_position_encoding(pkg.layers.data(
            "x", [2, 5, 5], append_batch_size=False))]

    for pkg in (jfluid, fluid):
        with pytest.raises(Exception, match="even encode size"):
            _run(pkg, build, {"x": odd})


def test_ctc_align():
    """ctc_greedy_decoder (top_k, then ctc_align): repeats merged,
    blanks dropped, the ids packed to the front over each row's
    length."""
    (ids, oln), _ = _check("ctc_align")
    np.testing.assert_array_equal(oln, [3, 1, 2, 0])
    np.testing.assert_array_equal(ids[0, :4], [1, 1, 2, 0])
    np.testing.assert_array_equal(ids[2, :3], [0, 0, 0])


def test_lstmp():
    """dynamic_lstmp (D 4, P 3) forward and reversed: Projection, Cell
    and the gradients of Input, Weight, ProjWeight and Bias."""
    out, _ = _check("lstmp")
    for proj, cell in ((out[0], out[1]), (out[2], out[3])):
        assert (proj[1, 1:] == 0).all() and (cell[3] == 0).all()


# -- cudnn_lstm (compat_ops.py) ----------------------------------------------

def test_cudnn_lstm():
    """One layer, and two bidirectional layers, over the same time-major
    input: Out, last_h, last_c and the gradients of Input, InitH and
    InitC (W takes none); the last step's output is last_h."""
    out, _ = _check("cudnn_lstm")
    np.testing.assert_allclose(out[0][-1], out[1][0], rtol=1e-6)
    assert out[3].shape == (5, 3, 6) and out[4].shape == (4, 3, 3)


# -- hierarchical_sigmoid (nn_ops.py) ----------------------------------------

def test_hierarchical_sigmoid():
    """The default tree at 7 classes and at 8 (a power of two, where a
    float log2 would misround the depth), and a custom tree whose paths
    pad with -1: Out and the gradients of X, W and Bias."""
    out, _ = _check("hierarchical_sigmoid")
    assert all((o > 0).all() for o in out[:3])
