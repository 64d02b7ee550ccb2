"""Host-side running metrics in numpy (counterpart
paddle_tpu/fluid/metrics.py, copied; reference
python/paddle/fluid/metrics.py)."""

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += value * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("No samples accumulated")
        return self.value / self.weight


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self.num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_score = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_score * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        for i, lab in zip(idx, labels):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])[::-1]
        fp = np.cumsum(self._stat_neg[::-1])[::-1]
        tot_pos, tot_neg = tp[0], fp[0]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        auc = np.sum((fp[:-1] - fp[1:]) * (tp[:-1] + tp[1:]) / 2.0)
        return float(auc / (tot_pos * tot_neg))


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """Binary precision (reference metrics.py Precision): preds are
    probabilities in [0,1], labels 0/1, threshold 0.5."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = preds >= 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        pred_pos = preds >= 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def eval(self):
        p = self.tp + self.fn
        return float(self.tp) / p if p else 0.0


class EditDistance(MetricBase):
    """Average edit distance + instance error rate (reference metrics.py
    EditDistance); consumes per-batch (distances, seq_num) pairs — the
    edit_distance op's outputs."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num=None):
        d = np.asarray(distances, np.float64).reshape(-1)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num if seq_num is not None else d.size)
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data added (reference raises too)")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class ChunkEvaluator(MetricBase):
    """Chunk-level precision/recall/F1 (reference metrics.py
    ChunkEvaluator); consumes (num_infer_chunks, num_label_chunks,
    num_correct_chunks) batch counts — what chunk-style decoders (e.g.
    crf_decoding label mode) aggregate."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class DetectionMAP(MetricBase):
    """Mean average precision over accumulated detections (reference
    metrics.py DetectionMAP core math, 11-point interpolation).

    update() takes per-image lists of (label, score, is_true_positive);
    the framework-level box matching happens in the detection pipeline
    (multiclass_nms + iou matching), this class owns the AP math."""

    def __init__(self, name=None, class_num=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__(name)
        self.class_num = class_num
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = {}      # class -> [(score, tp)]
        self._n_gt = {}      # class -> count

    def update(self, detections, gt_counts):
        """detections: iterable of (class, score, tp 0/1); gt_counts:
        {class: num ground-truth boxes in this batch}."""
        for c, score, tp in detections:
            self._dets.setdefault(int(c), []).append((float(score),
                                                      int(tp)))
        for c, n in dict(gt_counts).items():
            self._n_gt[int(c)] = self._n_gt.get(int(c), 0) + int(n)

    def eval(self):
        aps = []
        for c, n_gt in self._n_gt.items():
            dets = sorted(self._dets.get(c, ()), reverse=True)
            if not dets or n_gt == 0:
                aps.append(0.0)
                continue
            tps = np.array([tp for _s, tp in dets], np.float64)
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1 - tps)
            recall = tp_cum / n_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
            if self.ap_version == "11point":
                ap = np.mean([precision[recall >= t].max()
                              if (recall >= t).any() else 0.0
                              for t in np.linspace(0, 1, 11)])
            else:    # integral
                ap = 0.0
                prev_r = 0.0
                for r, p in zip(recall, precision):
                    ap += (r - prev_r) * p
                    prev_r = r
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0
