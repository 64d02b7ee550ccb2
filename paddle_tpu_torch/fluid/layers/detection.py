"""Detection layer builders (counterpart ``paddle_tpu/fluid/layers/
detection.py``; reference ``python/paddle/fluid/layers/detection.py``):
priors, box coding, matching and assignment, ``ssd_loss``,
``detection_output`` and ``multi_box_head``, the RPN / R-CNN and
RetinaNet builders, and the image-resize builders of the reference's
nn.py.  Each appends the same ops with the same attributes as the JAX
builder, so both packages build one program."""

from ..layer_helper import LayerHelper

__all__ = [
    "prior_box", "box_coder", "yolo_box", "multiclass_nms", "roi_align",
    "resize_bilinear", "resize_nearest", "image_resize",
]


def _interp(kind, input, out_shape, align_corners, align_mode, name):
    helper = LayerHelper(kind, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    oh, ow = int(out_shape[0]), int(out_shape[1])
    if input.shape:
        out.shape = tuple(input.shape[:2]) + (oh, ow)
    helper.append_op(kind, inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"out_h": oh, "out_w": ow,
                            "align_corners": align_corners,
                            "align_mode": align_mode})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True, align_mode=1):
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    return _interp("bilinear_interp", input, out_shape, align_corners,
                   align_mode, name)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    return _interp("nearest_interp", input, out_shape, align_corners, 1,
                   name)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True, align_mode=1):
    if resample.upper() == "BILINEAR":
        return resize_bilinear(input, out_shape, scale, name,
                               align_corners, align_mode)
    if resample.upper() == "NEAREST":
        return resize_nearest(input, out_shape, scale, name, align_corners)
    raise NotImplementedError(resample)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    elif prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]}, attrs=attrs)
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = helper.create_variable_for_type_inference(x.dtype)
    scores = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("yolo_box",
                     inputs={"X": [x], "ImgSize": [img_size]},
                     outputs={"Boxes": [boxes], "Scores": [scores]},
                     attrs={"anchors": list(anchors),
                            "class_num": int(class_num),
                            "conf_thresh": conf_thresh,
                            "downsample_ratio": downsample_ratio})
    return boxes, scores


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch_id=None,
              name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    helper.append_op("roi_align", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": sampling_ratio})
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, background_label=0,
                   name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    helper.append_op("multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out]},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": int(nms_top_k),
                            "keep_top_k": int(keep_top_k),
                            "nms_threshold": nms_threshold,
                            "normalized": normalized,
                            "background_label": int(background_label)})
    return out


# ---------------------------------------------------------------------------
# matching / assignment (reference detection.py:37-58 __all__ surface)
# ---------------------------------------------------------------------------

def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_distance = helper.create_variable_for_type_inference(
        dist_matrix.dtype)
    helper.append_op(
        "bipartite_match", inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices],
                 "ColToRowMatchDist": [match_distance]},
        attrs={"match_type": match_type or "bipartite",
               "dist_threshold": (0.5 if dist_threshold is None
                                  else dist_threshold)})
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op("target_assign", inputs=inputs,
                     outputs={"Out": [out], "OutWeight": [out_weight]},
                     attrs={"mismatch_value": mismatch_value or 0})
    return out, out_weight


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             name=None):
    """SSD multibox loss (reference detection.py ssd_loss): match priors
    to gt, hard-negative mine on the confidence loss, sum weighted
    localisation (smooth-L1) and confidence (softmax CE) losses.

    Static slabs: gt_box [B, G, 4] / gt_label [B, G, 1] padded with
    zero-area rows (they never match — IoU 0 < any threshold)."""
    from . import nn, nn_extras, tensor

    if mining_type != "max_negative":
        raise NotImplementedError("ssd_loss supports max_negative mining")
    num_prior = location.shape[1]
    # 1. IoU of every gt against every prior, per image
    iou = iou_similarity(x=gt_box, y=prior_box)
    # 2. match
    matched_indices, matched_dist = bipartite_match(iou, match_type,
                                                    overlap_threshold)
    # 3. confidence targets + first-pass loss for mining
    target_label, _ = target_assign(gt_label, matched_indices,
                                    mismatch_value=background_label)
    target_label = tensor.cast(target_label, "int64")
    target_label.stop_gradient = True
    conf2d = nn.reshape(confidence, [-1, confidence.shape[-1]])
    lbl2d = nn.reshape(target_label, [-1, 1])
    conf_loss = nn.softmax_with_cross_entropy(conf2d, lbl2d)
    # 4. hard-negative mining (per-image rows)
    helper = LayerHelper("ssd_loss", name=name)
    neg_indices = helper.create_variable_for_type_inference("int32")
    updated_match = helper.create_variable_for_type_inference("int32")
    conf_loss_pp = nn.reshape(conf_loss, [-1, num_prior])
    attrs = {"neg_pos_ratio": float(neg_pos_ratio),
             "neg_dist_threshold": float(neg_overlap),
             "mining_type": mining_type}
    if sample_size is not None:
        attrs["sample_size"] = int(sample_size)
    helper.append_op(
        "mine_hard_examples",
        inputs={"ClsLoss": [conf_loss_pp],
                "MatchIndices": [matched_indices],
                "MatchDist": [matched_dist]},
        outputs={"NegIndices": [neg_indices],
                 "UpdatedMatchIndices": [updated_match]}, attrs=attrs)
    # 5. localisation targets: encoded (gt, prior) slab gathered per prior
    encoded = box_coder(prior_box, prior_box_var, gt_box,
                        code_type="encode_center_size")
    target_bbox, target_loc_weight = target_assign(
        encoded, updated_match, mismatch_value=background_label)
    target_bbox.stop_gradient = True
    target_loc_weight.stop_gradient = True
    # 6. final confidence targets including mined negatives
    target_label2, target_conf_weight = target_assign(
        gt_label, updated_match, negative_indices=neg_indices,
        mismatch_value=background_label)
    target_label2 = tensor.cast(target_label2, "int64")
    target_label2.stop_gradient = True
    conf_loss = nn.softmax_with_cross_entropy(
        conf2d, nn.reshape(target_label2, [-1, 1]))
    conf_loss = conf_loss * nn.reshape(target_conf_weight, [-1, 1])
    loc_loss = nn_extras.smooth_l1(nn.reshape(location, [-1, 4]),
                                   nn.reshape(target_bbox, [-1, 4]))
    loc_loss = loc_loss * nn.reshape(target_loc_weight, [-1, 1])
    loss = conf_loss_weight * conf_loss + loc_loss_weight * loc_loss
    loss = nn.reshape(loss, [-1, num_prior])
    loss = nn.reduce_sum(loss, dim=1, keep_dim=True)
    if normalize:
        normalizer = nn.reduce_sum(target_loc_weight) + 1e-6
        loss = loss / normalizer
    return loss


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """Decode + multiclass NMS (reference detection.py detection_output)."""
    from . import nn
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores = nn.softmax(scores)
    scores = nn.transpose(scores, [0, 2, 1])
    return multiclass_nms(decoded, scores, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold,
                          background_label=background_label, name=name)


# ---------------------------------------------------------------------------
# RPN / R-CNN pipeline
# ---------------------------------------------------------------------------

def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None,
                     offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchor = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "anchor_generator", inputs={"Input": [input]},
        outputs={"Anchors": [anchor], "Variances": [var]},
        attrs={"anchor_sizes": [float(s) for s in
                                (anchor_sizes or [64., 128., 256., 512.])],
               "aspect_ratios": [float(r) for r in
                                 (aspect_ratios or [0.5, 1.0, 2.0])],
               "variances": [float(v) for v in variance],
               "stride": [float(s) for s in (stride or [16., 16.])],
               "offset": float(offset)})
    return anchor, var


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype)
    probs = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        "generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [probs]},
        attrs={"pre_nms_topN": int(pre_nms_top_n),
               "post_nms_topN": int(post_nms_top_n),
               "nms_thresh": float(nms_thresh),
               "min_size": float(min_size), "eta": float(eta)})
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True,
                      name=None):
    """Reference detection.py rpn_target_assign: assign anchors, then
    gather the predicted/target tensors by the sampled index lists."""
    from . import nn
    helper = LayerHelper("rpn_target_assign", name=name)
    loc_index = helper.create_variable_for_type_inference("int32")
    score_index = helper.create_variable_for_type_inference("int32")
    target_bbox = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    target_label = helper.create_variable_for_type_inference("int32")
    bbox_inside_weight = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    inputs = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        "rpn_target_assign", inputs=inputs,
        outputs={"LocationIndex": [loc_index],
                 "ScoreIndex": [score_index],
                 "TargetBBox": [target_bbox],
                 "TargetLabel": [target_label],
                 "BBoxInsideWeight": [bbox_inside_weight]},
        attrs={"rpn_batch_size_per_im": int(rpn_batch_size_per_im),
               "rpn_straddle_thresh": float(rpn_straddle_thresh),
               "rpn_positive_overlap": float(rpn_positive_overlap),
               "rpn_negative_overlap": float(rpn_negative_overlap),
               "rpn_fg_fraction": float(rpn_fg_fraction),
               "use_random": bool(use_random)})
    bbox_pred2 = nn.reshape(bbox_pred, [-1, 4])
    cls_logits2 = nn.reshape(cls_logits, [-1, 1])
    predicted_bbox = nn.gather(bbox_pred2, loc_index)
    predicted_scores = nn.gather(cls_logits2, score_index)
    return (predicted_scores, predicted_bbox, target_label, target_bbox,
            bbox_inside_weight)


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None,
                            im_info=None, num_classes=1,
                            positive_overlap=0.5, negative_overlap=0.4,
                            name=None):
    from . import nn
    helper = LayerHelper("retinanet_target_assign", name=name)
    loc_index = helper.create_variable_for_type_inference("int32")
    score_index = helper.create_variable_for_type_inference("int32")
    target_bbox = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    target_label = helper.create_variable_for_type_inference("int32")
    bbox_inside_weight = helper.create_variable_for_type_inference(
        anchor_box.dtype)
    fg_num = helper.create_variable_for_type_inference("int32")
    inputs = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
              "GtLabels": [gt_labels]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        "retinanet_target_assign", inputs=inputs,
        outputs={"LocationIndex": [loc_index],
                 "ScoreIndex": [score_index],
                 "TargetBBox": [target_bbox],
                 "TargetLabel": [target_label],
                 "BBoxInsideWeight": [bbox_inside_weight],
                 "ForegroundNumber": [fg_num]},
        attrs={"positive_overlap": float(positive_overlap),
               "negative_overlap": float(negative_overlap)})
    bbox_pred2 = nn.reshape(bbox_pred, [-1, 4])
    cls_logits2 = nn.reshape(cls_logits, [-1, num_classes])
    predicted_bbox = nn.gather(bbox_pred2, loc_index)
    predicted_scores = nn.gather(cls_logits2, score_index)
    return (predicted_scores, predicted_bbox, target_label, target_bbox,
            bbox_inside_weight, fg_num)


def sigmoid_focal_loss(x, label, fg_num, gamma=2, alpha=0.25, name=None):
    helper = LayerHelper("sigmoid_focal_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_focal_loss",
                     inputs={"X": [x], "Label": [label], "FgNum": [fg_num]},
                     outputs={"Out": [out]},
                     attrs={"gamma": float(gamma), "alpha": float(alpha)})
    return out


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             name=None):
    helper = LayerHelper("generate_proposal_labels", name=name)
    rois = helper.create_variable_for_type_inference(rpn_rois.dtype)
    labels_int32 = helper.create_variable_for_type_inference("int32")
    bbox_targets = helper.create_variable_for_type_inference(
        rpn_rois.dtype)
    bbox_inside_weights = helper.create_variable_for_type_inference(
        rpn_rois.dtype)
    bbox_outside_weights = helper.create_variable_for_type_inference(
        rpn_rois.dtype)
    inputs = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
              "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        "generate_proposal_labels", inputs=inputs,
        outputs={"Rois": [rois], "LabelsInt32": [labels_int32],
                 "BboxTargets": [bbox_targets],
                 "BboxInsideWeights": [bbox_inside_weights],
                 "BboxOutsideWeights": [bbox_outside_weights]},
        attrs={"batch_size_per_im": int(batch_size_per_im),
               "fg_fraction": float(fg_fraction),
               "fg_thresh": float(fg_thresh),
               "bg_thresh_hi": float(bg_thresh_hi),
               "bg_thresh_lo": float(bg_thresh_lo),
               "class_nums": int(class_nums or 81),
               "bbox_reg_weights": [float(w) for w in bbox_reg_weights],
               "use_random": bool(use_random)})
    return (rois, labels_int32, bbox_targets, bbox_inside_weights,
            bbox_outside_weights)


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_batch_id=None, name=None):
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mask = helper.create_variable_for_type_inference("int32")
    matrix = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    helper.append_op(
        "roi_perspective_transform", inputs=inputs,
        outputs={"Out": [out], "Mask": [mask],
                 "TransformMatrix": [matrix]},
        attrs={"transformed_height": int(transformed_height),
               "transformed_width": int(transformed_width),
               "spatial_scale": float(spatial_scale)})
    return out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    num_lvl = max_level - min_level + 1
    multi_rois = [helper.create_variable_for_type_inference(fpn_rois.dtype)
                  for _ in range(num_lvl)]
    restore_ind = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "distribute_fpn_proposals", inputs={"FpnRois": [fpn_rois]},
        outputs={"MultiFpnRois": multi_rois,
                 "RestoreIndex": [restore_ind]},
        attrs={"min_level": int(min_level), "max_level": int(max_level),
               "refer_level": int(refer_level),
               "refer_scale": int(refer_scale)})
    return multi_rois, restore_ind


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    helper = LayerHelper("collect_fpn_proposals", name=name)
    num_lvl = max_level - min_level + 1
    out = helper.create_variable_for_type_inference(multi_rois[0].dtype)
    helper.append_op(
        "collect_fpn_proposals",
        inputs={"MultiLevelRois": multi_rois[:num_lvl],
                "MultiLevelScores": multi_scores[:num_lvl]},
        outputs={"FpnRois": [out]},
        attrs={"post_nms_topN": int(post_nms_top_n)})
    return out


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = helper.create_variable_for_type_inference(prior_box.dtype)
    assigned = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(
        "box_decoder_and_assign",
        inputs={"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box], "BoxScore": [box_score]},
        outputs={"DecodeBox": [decoded], "OutputAssignBox": [assigned]},
        attrs={"box_clip": float(box_clip)})
    return decoded, assigned


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0, name=None):
    helper = LayerHelper("retinanet_detection_output", name=name)
    out = helper.create_variable_for_type_inference(bboxes[0].dtype)
    helper.append_op(
        "retinanet_detection_output",
        inputs={"BBoxes": list(bboxes), "Scores": list(scores),
                "Anchors": list(anchors), "ImInfo": [im_info]},
        outputs={"Out": [out]},
        attrs={"score_threshold": float(score_threshold),
               "nms_top_k": int(nms_top_k),
               "keep_top_k": int(keep_top_k),
               "nms_threshold": float(nms_threshold),
               "nms_eta": float(nms_eta)})
    return out


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    objectness_mask = helper.create_variable_for_type_inference(x.dtype)
    gt_match_mask = helper.create_variable_for_type_inference("int32")
    inputs = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        inputs["GTScore"] = [gt_score]
    helper.append_op(
        "yolov3_loss", inputs=inputs,
        outputs={"Loss": [loss], "ObjectnessMask": [objectness_mask],
                 "GTMatchMask": [gt_match_mask]},
        attrs={"anchors": [int(a) for a in anchors],
               "anchor_mask": [int(m) for m in anchor_mask],
               "class_num": int(class_num),
               "ignore_thresh": float(ignore_thresh),
               "downsample_ratio": int(downsample_ratio),
               "use_label_smooth": bool(use_label_smooth)})
    return loss


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         name=None):
    """Mask R-CNN mask targets (ops/detection_ops3.py host-callback
    rasteriser; gt_segms is the padded [G, P, 2] polygon slab)."""
    helper = LayerHelper("generate_mask_labels", name=name)
    mask_rois = helper.create_variable_for_type_inference(rois.dtype)
    roi_has_mask = helper.create_variable_for_type_inference("int32")
    mask_int32 = helper.create_variable_for_type_inference("int32")
    inputs = {"ImInfo": [im_info], "GtClasses": [gt_classes],
              "GtSegms": [gt_segms], "Rois": [rois],
              "LabelsInt32": [labels_int32]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    helper.append_op(
        "generate_mask_labels", inputs=inputs,
        outputs={"MaskRois": [mask_rois],
                 "RoiHasMaskInt32": [roi_has_mask],
                 "MaskInt32": [mask_int32]},
        attrs={"num_classes": int(num_classes),
               "resolution": int(resolution)})
    return mask_rois, roi_has_mask, mask_int32


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("box_clip",
                     inputs={"Input": [input], "ImInfo": [im_info]},
                     outputs={"Output": [out]})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("polygon_box_transform", inputs={"Input": [input]},
                     outputs={"Output": [out]})
    return out


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype)
    var = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"densities": [int(d) for d in (densities or [])],
               "fixed_sizes": [float(s) for s in (fixed_sizes or [])],
               "fixed_ratios": [float(r) for r in (fixed_ratios or [1.])],
               "variances": [float(v) for v in variance],
               "clip": bool(clip), "step_w": float(steps[0]),
               "step_h": float(steps[1]), "offset": float(offset),
               "flatten_to_2d": bool(flatten_to_2d)})
    return boxes, var


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference detection.py multi_box_head): a 3x3
    conv per feature map for box offsets and class scores, plus priors;
    everything reshaped and concatenated across maps."""
    from . import nn, tensor

    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio interpolation
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2))
        min_sizes.append(base_size * 0.1)
        max_sizes.append(base_size * 0.2)
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = min_sizes[:n_layer]
        max_sizes = max_sizes[:n_layer]

    locs, confs, prior_boxes, prior_vars = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[0],
                                            (list, tuple)) else aspect_ratios
        st = steps[i] if steps else [step_w[i] if step_w else 0.0,
                                     step_h[i] if step_h else 0.0]
        ms_list = [ms] if not isinstance(ms, (list, tuple)) else list(ms)
        mx_list = ([mx] if mx and not isinstance(mx, (list, tuple))
                   else list(mx or []))
        box, var = prior_box(
            feat, image, ms_list, mx_list, ar, variance, flip, clip,
            (float(st[0]), float(st[1])), offset)
        # priors per location, mirroring the prior_box op's box list:
        # per min_size every (deduped, optionally flipped) ratio + the
        # max_size sqrt box
        ars = [1.0]
        for r in ar:
            if not any(abs(float(r) - a) < 1e-6 for a in ars):
                ars.append(float(r))
                if flip:
                    ars.append(1.0 / float(r))
        num_boxes = len(ms_list) * len(ars) + len(mx_list)
        # conv predictors
        loc = nn.conv2d(feat, num_filters=num_boxes * 4,
                        filter_size=kernel_size, padding=pad, stride=stride)
        conf = nn.conv2d(feat, num_filters=num_boxes * num_classes,
                         filter_size=kernel_size, padding=pad,
                         stride=stride)
        # [N, P*4, Ho, Wo] -> [N, Ho*Wo*P, 4] (conv output size)
        ho = (int(feat.shape[2]) + 2 * pad - kernel_size) // stride + 1
        wo = (int(feat.shape[3]) + 2 * pad - kernel_size) // stride + 1
        n_loc = ho * wo * num_boxes
        loc = nn.transpose(loc, [0, 2, 3, 1])
        loc = nn.reshape(loc, [-1, n_loc, 4])
        conf = nn.transpose(conf, [0, 2, 3, 1])
        conf = nn.reshape(conf, [-1, n_loc, num_classes])
        locs.append(loc)
        confs.append(conf)
        prior_boxes.append(nn.reshape(box, [-1, 4]))
        prior_vars.append(nn.reshape(var, [-1, 4]))

    mbox_locs = tensor.concat(locs, axis=1)
    mbox_confs = tensor.concat(confs, axis=1)
    boxes = tensor.concat(prior_boxes, axis=0)
    vars_ = tensor.concat(prior_vars, axis=0)
    return mbox_locs, mbox_confs, boxes, vars_


__all__ += [
    "iou_similarity", "bipartite_match", "target_assign", "ssd_loss",
    "detection_output", "anchor_generator", "generate_proposals",
    "rpn_target_assign", "retinanet_target_assign", "sigmoid_focal_loss",
    "generate_proposal_labels", "roi_perspective_transform",
    "distribute_fpn_proposals", "collect_fpn_proposals",
    "box_decoder_and_assign", "retinanet_detection_output", "yolov3_loss",
    "box_clip", "polygon_box_transform", "density_prior_box",
    "multi_box_head", "generate_mask_labels",
]
