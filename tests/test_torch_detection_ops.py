"""The 33 detection op types of the port (paddle_tpu_torch), each against
paddle_tpu on the CPU on the same seeded numpy inputs: iou_similarity,
smooth_l1_loss, prior_box, box_coder, multiclass_nms, bipartite_match,
target_assign, mine_hard_examples, nearest_interp, bilinear_interp,
yolo_box, roi_align, box_decoder_and_assign, collect_fpn_proposals,
distribute_fpn_proposals, yolov3_loss, sigmoid_focal_loss, box_clip,
anchor_generator, density_prior_box, polygon_box_transform, roi_pool,
psroi_pool, generate_proposals, rpn_target_assign,
retinanet_target_assign, generate_proposal_labels,
retinanet_detection_output, detection_map, generate_mask_labels,
roi_perspective_transform, deformable_conv and deformable_psroi_pooling.

The programs are ``chip_smoke.det_programs()``, which the card's
``detection_ops`` phase runs too: each builds its op in both packages
through the layer a user calls (by hand for ``mine_hard_examples`` and
``detection_map``), every mode side by side, then ``fluid.gradients``
of ``sum mean(out²)`` over the float inputs the op differentiates and
its parameters.  ``test_op_against_jax`` holds every fetch of each
program; the tests after it check values by hand, the tie orders
(a tied IoU matched to its first row, NMS padding rows taken from the
-1-score ties), and the sampling invariants of ``use_random``, whose
streams differ across the packages.

Tolerances (``chip_smoke.DET_TOL``): float32 ``rtol 1e-5, atol 1e-6``;
``yolo_box``, whose boxes are in image pixels, ``atol 1e-4``;
``roi_perspective_transform``, whose homographies are 8 x 8 solves,
``rtol 1e-4, atol 1e-5``; integer outputs (match indices, keep masks,
sampled indices, labels) and ``detection_map``'s mAP exactly.
"""

import functools

import numpy as np
import pytest

import chip_smoke
from chip_smoke import (DET_HOST_OPS, DET_TOL, det_programs, seq_run,
                        seq_weights)
from test_torch_book_ops import _both
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

import paddle_tpu_torch.fluid as fluid

PROGRAMS = det_programs()
TYPES = sorted(PROGRAMS)


@functools.lru_cache(maxsize=None)
def _check(name):
    """Both packages' fetches of program ``name`` held at its tolerance;
    returns the port's fetches."""
    build, feed, seed, tol = PROGRAMS[name]
    rtol, atol = DET_TOL[tol]
    init = seq_weights(build, seed) if seed is not None else None
    out, _ = _both(build, feed, rtol, atol, init=init)
    return tuple(out)


def _feed(name):
    return PROGRAMS[name][1]


def test_every_op_type_has_a_program():
    """33 programs, one a type, all registered: the port's 324 op types
    that are not ``_grad`` (207 before detection, 240 before the core op
    types and ``fill_any_like``, 275 before the 49 of ``misc_ops.py`` and
    ``misc_ops2.py``)."""
    assert len(PROGRAMS) == 33
    assert set(PROGRAMS) <= set(fluid.registry.OP_DEFS)
    assert len([t for t in fluid.registry.OP_DEFS
                if not t.endswith("_grad")]) == 324


@pytest.mark.parametrize("name", TYPES)
def test_registration_flags_are_the_jax_ones(name):
    """``nondiff_inputs`` and ``stop_gradient`` as JAX registers them."""
    from paddle_tpu.fluid.registry import OP_DEFS as JAX_DEFS
    mine, jax_def = fluid.registry.OP_DEFS[name], JAX_DEFS[name]
    assert mine.nondiff_inputs == jax_def.nondiff_inputs
    assert mine.stop_gradient == jax_def.stop_gradient


@pytest.mark.parametrize("name", TYPES)
def test_op_against_jax(name):
    """Every fetch (outputs and gradients) of the op's program, the port
    against JAX: floats within DET_TOL, integers equal."""
    out = _check(name)
    assert len(out) >= 1
    assert all(np.isfinite(o).all() for o in out if o.dtype.kind == "f")


# -- values by hand -----------------------------------------------------------

def test_prior_box_count_and_range():
    """Two min sizes, ratios 1, 2, 1/2, 3, 1/3 and a max square each:
    12 priors a location, clipped into [0, 1]; one min size with the
    repeated ratio 2 unflipped: 2."""
    b1, v1, b2, _ = _check("prior_box")
    assert b1.shape == (3, 4, 12, 4) and (b1 >= 0).all() and (b1 <= 1).all()
    np.testing.assert_allclose(v1[..., 2], 0.2)
    assert b2.shape == (3, 4, 2, 4)


def test_box_coder_round_trip():
    """Decoding the encoding of a box against its own prior gives the
    box back."""
    enc2 = _check("box_coder")[0]
    feed = _feed("box_coder")
    prior, pvar, t2 = feed["prior"], feed["pvar"], feed["t2"]
    pw, ph = prior[:, 2] - prior[:, 0], prior[:, 3] - prior[:, 1]
    d = enc2[0] * pvar                                   # box 0, all priors
    cx = d[:, 0] * pw + prior[:, 0] + pw / 2
    w = np.exp(d[:, 2]) * pw
    np.testing.assert_allclose(cx - w / 2, t2[0, 0], rtol=1e-5, atol=1e-5)


def test_multiclass_nms_slab():
    """``[2, 10, 6]``, kept rows first by score, each kept label a
    foreground class above the threshold, -1 rows after; the exact
    duplicate box never appears twice in one class."""
    out = _check("multiclass_nms")[0]
    assert out.shape == (2, 10, 6)
    for img in out:
        kept = img[img[:, 0] >= 0]
        assert (np.diff(kept[:, 1]) <= 0).all()
        assert ((kept[:, 0] >= 1) & (kept[:, 1] > 0.03)).all()
        for c in np.unique(kept[:, 0]):
            rows = kept[kept[:, 0] == c][:, 2:]
            assert len(np.unique(rows, axis=0)) == len(rows)


def test_nms_padding_rows_come_from_ties():
    """When fewer boxes than ``keep_top_k`` survive, the padding rows are
    the lowest-index candidates of score -1 (the background class's
    zero boxes first), in both packages alike: lax.top_k's tie order,
    which a stable sort reproduces."""
    rng = np.random.RandomState(3)
    boxes = chip_smoke._det_boxes(rng, 4, 1.0)[None]
    scores = np.zeros((1, 3, 4), np.float32)
    scores[0, 1, 2] = 0.9                                 # one candidate

    def build(pkg):
        b = chip_smoke._seq_data(pkg, "b", boxes, False)
        s = chip_smoke._seq_data(pkg, "s", scores, False)
        return [pkg.layers.multiclass_nms(b, s, 0.05, 4, 6)]
    (out,), _ = _both(build, {"b": boxes, "s": scores}, 0.0, 0.0)
    np.testing.assert_allclose(out[0, 0], [1, 0.9] + list(boxes[0, 2]))
    # then the -1 ties in index order: background (class 0) slots hold
    # zero boxes; the rest of class 1's top-4 follow
    assert (out[0, 1:, 0] == -1).all() and (out[0, 1:, 1] == -1).all()
    np.testing.assert_array_equal(out[0, 1:5, 2:], 0.0)
    np.testing.assert_array_equal(out[0, 5, 2:], boxes[0, 0])


def test_bipartite_match_takes_the_first_of_tied_maxima():
    """Equal IoUs against one ground truth (grid priors): the greedy
    round takes the first maximum of the flattened matrix, as
    ``jnp.argmax`` does; the padding row matches nothing."""
    i1, d1, i2, _, i3, _ = _check("bipartite_match")
    dist = _feed("bipartite_match")["d"]
    # image 0: rows 1 and 2 tie at the top (columns 2 and 5): row 1 first
    assert i1[0, 2] == 1 and i1[0, 5] != 1
    assert (i1[1] != 0).all()                 # row 0 of image 1 is padding
    assert ((i1 >= 0).sum(axis=1) == [3, 2]).all()
    assert (i2 >= i1).all() or ((i1 == -1) | (i2 == i1)).all()
    assert i3.shape == (1, 6)
    # per_prediction fills unmatched columns with their best row >= 0.4
    extra = (i1 == -1) & (i2 >= 0)
    assert (dist[extra.nonzero()[0], i2[extra], extra.nonzero()[1]] >= 0.4) \
        .all()


def test_bipartite_tie_in_one_image():
    """A one-image tie by construction: the ground truth's IoU against
    priors 1 and 3 is equal, and prior 1 is matched."""
    dist = np.array([[[0.2, 0.7, 0.1, 0.7]]], np.float32)

    def build(pkg):
        d = chip_smoke._seq_data(pkg, "d", dist, False)
        return list(pkg.layers.bipartite_match(d))
    (idx, md), _ = _both(build, {"d": dist}, 0.0, 0.0)
    np.testing.assert_array_equal(idx, [[-1, 0, -1, -1]])
    np.testing.assert_allclose(md[0, 1], 0.7)


def test_mine_hard_examples_counts():
    """max_negative: 3 x the positives of each image (6 and 3), the
    largest eligible losses first; hard_example: sample_size 4."""
    neg, upd, neg2, _ = _check("mine_hard_examples")
    feed = _feed("mine_hard_examples")
    np.testing.assert_array_equal(upd, feed["mi"])
    elig = (feed["mi"] == -1) & (feed["md"] < 0.5)
    for b, want in enumerate((min(6, elig[0].sum()), min(3, elig[1].sum()))):
        got = neg[b][neg[b] >= 0]
        assert len(got) == want and elig[b, got].all()
        assert (np.diff(feed["cl"][b, got]) <= 0).all()
    assert ((neg2 >= 0).sum(axis=1) == np.minimum(4, elig.sum(1))).all()


def test_target_assign_weights():
    """Matched rows weight 1, unmatched 0, listed negatives weight 1 with
    the mismatch value."""
    o1, w1, _, _, o3, w3 = _check("target_assign")
    feed = _feed("target_assign")
    m = feed["m"]
    np.testing.assert_array_equal(w1[..., 0], (m >= 0).astype(np.float32))
    np.testing.assert_array_equal(o1[0, 0], feed["x"][0, 0])
    assert w3[0, 1, 0] == 1 and o3[0, 1, 0] == 0          # negative 1
    assert w3[1, 2, 0] == 1 and w3[1, 3, 0] == 1


def test_distribute_restores_the_order():
    """concat(levels)[RestoreIndex] is the input."""
    *levels, restore = _check("distribute_fpn_proposals")
    both = np.concatenate(levels)
    np.testing.assert_array_equal(both[restore[:, 0]],
                                  _feed("distribute_fpn_proposals")["r"])


def test_detection_map_values():
    """Integral AP with difficult boxes evaluated, and 11-point AP
    without, against the AP worked out from the slabs."""
    m1, _, _, _, m2 = _check("detection_map")[:5]
    # class 1: gts 2 (image 0) + 1 (image 1); detections by score 0.9 TP,
    # 0.7 TP (IoU 0.84 with the difficult gt), 0.5 FP, 0.4 TP; class 2:
    # 2 gts, 0.95 TP, 0.8 TP, 0.6 FP
    ap1 = 1 / 3 + 1 / 3 + 0.75 * (1 / 3)
    np.testing.assert_allclose(m1[0], np.float32((ap1 + 1.0) / 2),
                               rtol=1e-6)
    assert 0 < m2[0] <= 1


def test_detection_map_syncs_only_on_the_card():
    """On the CPU the host ops make no host sync."""
    build, feed, _, _ = PROGRAMS["detection_map"]
    _, syncs, n_host = seq_run(build, feed, {}, fluid.CPUPlace(), DET_HOST_OPS)
    assert syncs == 0 and n_host == 2


def test_generate_mask_labels_values():
    """The first ROI takes the left half of its square polygon in its
    class-2 slot; the background ROI has no mask."""
    _, has, masks = _check("generate_mask_labels")
    np.testing.assert_array_equal(has[:, 0], [1, 1, 0, 1])
    m = masks[0].reshape(3, 4, 4)
    np.testing.assert_array_equal(m[2][:, :2], 1)
    np.testing.assert_array_equal(m[2][:, 2:], 0)
    assert (m[0] == -1).all() and (m[1] == -1).all()
    assert (masks[2] == -1).all()


def test_generate_proposals_slabs():
    """Probabilities descending, boxes inside each image, zero padding
    past the kept ones."""
    r1, p1, r2, p2 = _check("generate_proposals")
    assert r1.shape == (2, 5, 4) and p2.shape == (2, 40, 1)
    assert (np.diff(p1[..., 0], axis=1) <= 0).all()
    assert r1[0].max() <= 63 and r1.min() >= 0
    assert (p2[:, 30:] == 0).all() and (r2[:, 30:] == 0).all()


def test_rpn_target_assign_without_random():
    """The lowest eligible anchors: foreground slots first (weight 1 up
    to the count), labels 1 then 0."""
    out = _check("rpn_target_assign")
    iw, tl, loc_idx, score_idx = out[3], out[-3], out[-2], out[-1]
    assert loc_idx.shape == (4,) and score_idx.shape == (16,)
    np.testing.assert_array_equal(tl[:, 0], [1] * 4 + [0] * 12)
    n_fg = int(iw[:, 0].sum())
    assert n_fg >= 2 and (np.diff(loc_idx[:n_fg]) > 0).all()


def test_rpn_target_assign_random_invariants():
    """With ``use_random`` the two packages draw different streams; the
    port's picks are eligible, distinct, and as many as the pools
    allow."""
    anchors = PROGRAMS["rpn_target_assign"][1]["a"]
    gt = PROGRAMS["rpn_target_assign"][1]["gt"]

    def build(pkg):
        D = chip_smoke._seq_data
        bp = D(pkg, "bp", np.zeros((48, 4), np.float32), False)
        cl = D(pkg, "cl", np.zeros((48, 1), np.float32), False)
        pkg.layers.rpn_target_assign(
            bp, cl, D(pkg, "a", anchors, False), D(pkg, "a2", anchors, False),
            D(pkg, "gt", gt, False), rpn_batch_size_per_im=16,
            rpn_fg_fraction=0.25, use_random=True)
        return [chip_smoke._seq_op_output(pkg, "rpn_target_assign", s)
                for s in ("LocationIndex", "ScoreIndex",
                          "BBoxInsideWeight")]
    feed = {"bp": np.zeros((48, 4), np.float32),
            "cl": np.zeros((48, 1), np.float32), "a": anchors,
            "a2": anchors, "gt": gt}
    loc, score, iw = seq_run(build, feed, {}, fluid.CPUPlace())[0]
    # the JAX rule's eligibility, computed here in numpy
    g = gt[(gt[:, 2] > gt[:, 0]) & (gt[:, 3] > gt[:, 1])]
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    gw, gh = g[:, 2] - g[:, 0] + 1, g[:, 3] - g[:, 1] + 1
    iw_ = np.clip(np.minimum(anchors[:, None, 2], g[None, :, 2]) -
                  np.maximum(anchors[:, None, 0], g[None, :, 0]) + 1, 0, None)
    ih_ = np.clip(np.minimum(anchors[:, None, 3], g[None, :, 3]) -
                  np.maximum(anchors[:, None, 1], g[None, :, 1]) + 1, 0, None)
    inter = iw_ * ih_
    iou = inter / (aw[:, None] * ah[:, None] + (gw * gh)[None] - inter)
    best = (np.abs(iou - iou.max(0)[None]) < 1e-5) & (iou > 0)
    fg = best.any(1) | (iou.max(1) >= 0.7)
    bg = iou.max(1) < 0.3
    n_fg = min(4, fg.sum())
    assert int(iw[:, 0].sum()) == n_fg
    assert fg[loc[:n_fg]].all() and len(set(loc[:n_fg])) == n_fg
    assert bg[score[4:]].all() and len(set(score[4:])) == 12


def test_retinanet_target_assign_counts():
    """ForegroundNumber is the foreground count; score labels run gt
    classes, then 0, then -1."""
    out = _check("retinanet_target_assign")
    tl, fg = out[-4], out[-3]
    n = int(fg[0])
    assert n >= 2
    assert (tl[:n, 0] >= 1).all() and (tl[n:, 0] <= 0).all()


def test_generate_proposal_labels_rows():
    """The gt box and the ROI over it are foreground (class 3) with
    weights in the class-3 slot; padding rows are label -1."""
    rois, lab, tgt, iw, ow = _check("generate_proposal_labels")
    assert rois.shape == (8, 4) and lab.shape == (8, 1)
    fg = lab[:, 0] == 3
    assert fg.sum() >= 2
    np.testing.assert_array_equal(iw[fg][:, 12:16], 1.0)
    assert (iw[fg][:, :12] == 0).all() and (iw == ow).all()


def test_retinanet_detection_output_slab():
    out = _check("retinanet_detection_output")
    assert out[0].shape == (2, 12, 6) and out[1].shape == (2, 40, 6)
    lab = out[1][..., 0]
    assert set(np.unique(lab)) <= {-1.0, 1.0, 2.0, 3.0}


def test_deformable_conv_without_offsets_is_a_conv():
    """Zero offsets and a unit mask: a plain grouped convolution."""
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(5)
    x = rng.randn(1, 4, 5, 5).astype(np.float32)
    w = rng.randn(6, 2, 3, 3).astype(np.float32)

    def build(pkg):
        D = chip_smoke._seq_data
        return [pkg.layers.deformable_conv(
            D(pkg, "x", x, False),
            D(pkg, "o", np.zeros((1, 18, 5, 5), np.float32), False),
            D(pkg, "m", np.ones((1, 9, 5, 5), np.float32), False), 6, 3,
            padding=1, groups=2)]
    main_w = {"deformable_conv_0.w_0": w}
    feed = {"x": x, "o": np.zeros((1, 18, 5, 5), np.float32),
            "m": np.ones((1, 9, 5, 5), np.float32)}
    out = seq_run(build, feed, main_w, fluid.CPUPlace())[0][0]
    want = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1,
                    groups=2).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_roi_align_fixed_sampling():
    """``sampling_ratio <= 0`` samples 2 x 2 a bin (the JAX rule), not the
    reference's ceil(bin size): a ROI over a ramp image averages four
    reads."""
    x = np.tile(np.arange(8, dtype=np.float32), (1, 1, 8, 1))
    rois = np.array([[0, 0, 4, 4]], np.float32)

    def build(pkg):
        D = chip_smoke._seq_data
        return [pkg.layers.roi_align(D(pkg, "x", x, False),
                                     D(pkg, "r", rois, False), 1, 1, 1.0,
                                     -1)]
    (out,), _ = _both(build, {"x": x, "r": rois}, 1e-6, 1e-6)
    # samples at x = 1 and 3 (bin 4 wide, 2 samples): mean 2
    np.testing.assert_allclose(out[0, 0, 0, 0], 2.0, rtol=1e-6)


def test_ssd_priors_are_bit_equal_to_jax():
    """The priors of MobileNet-SSD's head at the test config's six maps
    (6², 3², 2², 1², 1², 1²: a divide on the 1-long maps, a product with
    the float32 reciprocal on the others, as XLA computes them) equal
    JAX's bit for bit, so equal IoUs stay equal and matching ties break
    alike."""
    from paddle_tpu_torch.models import ssd
    cfg = ssd.test_config()
    sides = ssd.map_sides(cfg)
    img = np.zeros((1, 3, cfg["image"], cfg["image"]), np.float32)
    maps = [np.zeros((1, 2, s, s), np.float32) for s in sides]

    def build(pkg):
        D = chip_smoke._seq_data
        image = D(pkg, "img", img, False)
        fetch = []
        for k, m in enumerate(maps):
            box, var = pkg.layers.prior_box(
                D(pkg, "m%d" % k, m, False), image, [cfg["min_sizes"][k]],
                [cfg["max_sizes"][k]] if cfg["max_sizes"][k] else None,
                [2.0] if k == 0 else [2.0, 3.0], flip=True)
            fetch += [box, var]
        return fetch
    feed = dict({"m%d" % k: m for k, m in enumerate(maps)}, img=img)
    out, _ = _both(build, feed, 0.0, 0.0)
    assert sides == [6, 3, 2, 1, 1, 1]
    assert sum(o.shape[0] * o.shape[1] * o.shape[2]
               for o in out[::2]) == ssd.num_priors(cfg)
