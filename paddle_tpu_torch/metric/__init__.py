"""paddle.metric (port of paddle_tpu/metric/__init__.py): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc``, ``PrecisionRecall``,
``ChunkEvaluator``, ``DetectionMAP`` and the functions ``accuracy``,
``mean_iou`` and ``edit_distance``.

As in the reference, ``compute`` runs on the model's outputs and
``update``/``accumulate`` on small host values: ``Model`` fetches what
``compute`` returns (one copy a step) and hands ``update`` numpy arrays.
Here ``compute``, ``accuracy`` and ``mean_iou`` are torch code on the
tensors' own device.

Ranking keeps the order of a stable sort of ``-pred``: on equal scores
the lower class index comes first (``torch.argmax``, the first maximum,
for k = 1, a stable sort for k > 1; never ``torch.topk``, whose order on
ties is not fixed).  The reference ranks with ``np.argsort(-pred)``, whose
default sort is stable for up to three classes only: with four or more,
numpy 2 breaks ties in an order of its own.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc",
           "PrecisionRecall", "ChunkEvaluator", "DetectionMAP", "accuracy",
           "mean_iou", "edit_distance"]


def _host(x) -> np.ndarray:
    """A value handed to ``update`` as a numpy array (a tensor on any
    device; bfloat16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _ranked(pred, k):
    """The indices of the ``k`` highest scores along the last axis, in the
    order of a stable sort of ``-pred``."""
    if k == 1:
        return pred.argmax(-1, keepdim=True)
    return torch.sort(pred.neg(), dim=-1, stable=True).indices[..., :k]


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """[..., maxk] float32: whether each of the top ``maxk`` classes is
        the label, on ``pred``'s device."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        idx = _ranked(pred, self.maxk)
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        return (idx == label[..., None]).to(torch.float32)

    def update(self, correct, *args):
        c = _host(correct)
        accs = []
        for k in self.topk:
            num = c[..., :k].sum()
            accs.append(num / max(c.shape[0], 1))
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += c.shape[0]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _host(preds).round().astype(np.int32).ravel()
        l = _host(labels).astype(np.int32).ravel()
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _host(preds).round().astype(np.int32).ravel()
        l = _host(labels).astype(np.int32).ravel()
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _host(preds)
        if p.ndim == 2:
            p = p[:, 1]
        l = _host(labels).ravel()
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds).ravel()
        n = min(len(bins), len(l))        # the reference zips the two
        bins, pos = bins[:n], l[:n].astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2
            tot_pos, tot_neg = new_pos, new_neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` highest scores
    (metrics/accuracy_op.cc), a float32 scalar on ``input``'s device."""
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device)
    idx = _ranked(input, k)
    ll = label if label.ndim == input.ndim - 1 else label.squeeze(-1)
    return (idx == ll[..., None]).any(-1).to(torch.float32).mean()


class PrecisionRecall(Metric):
    """Streaming multi-class precision/recall/F1
    (operators/metrics/precision_recall_op.cc): per-class TP/FP/FN from
    argmax predictions, macro + micro averages."""

    def __init__(self, num_classes, name="precision_recall"):
        self._name = name
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self._tp = np.zeros(self.num_classes, np.int64)
        self._fp = np.zeros(self.num_classes, np.int64)
        self._fn = np.zeros(self.num_classes, np.int64)

    def update(self, preds, labels):
        p = _host(preds)
        if p.ndim == 2:
            p = p.argmax(-1)
        p = p.ravel().astype(np.int64)
        y = _host(labels).ravel().astype(np.int64)
        C = self.num_classes
        # ids outside [0, C) count as a miss of the valid side's class
        vp = (p >= 0) & (p < C)
        vy = (y >= 0) & (y < C)
        both = vp & vy
        conf = np.bincount(y[both] * C + p[both],
                           minlength=C * C).reshape(C, C)
        tp = np.diag(conf)
        self._tp += tp
        self._fp += conf.sum(0) - tp
        self._fn += conf.sum(1) - tp
        if not both.all():
            self._fn += np.bincount(y[vy & ~vp], minlength=C)
            self._fp += np.bincount(p[vp & ~vy], minlength=C)

    @staticmethod
    def _prf(tp, fp, fn):
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return prec, rec, f1

    def accumulate(self):
        """(macro_p, macro_r, macro_f1, micro_p, micro_r, micro_f1)."""
        per = [self._prf(int(t), int(f), int(n))
               for t, f, n in zip(self._tp, self._fp, self._fn)]
        macro = tuple(float(np.mean([x[i] for x in per]))
                      for i in range(3))
        micro = self._prf(int(self._tp.sum()), int(self._fp.sum()),
                          int(self._fn.sum()))
        return macro + tuple(float(x) for x in micro)


def mean_iou(input, label, num_classes):
    """Mean intersection-over-union over classes
    (operators/metrics/mean_iou_op.h), on ``input``'s device: (miou, the
    per-class iou, the mask of classes present).  As the reference's
    scatter does, an id in [-num_classes, 0) counts for the class it
    indexes from the end; other ids outside [0, num_classes) count
    nowhere."""
    p = torch.as_tensor(input).reshape(-1).to(torch.int64)
    y = torch.as_tensor(label, device=p.device).reshape(-1).to(torch.int64)

    def counts(idx, weight):
        idx = torch.where(idx < 0, idx + num_classes, idx)
        ok = (idx >= 0) & (idx < num_classes)
        return torch.zeros(num_classes, dtype=torch.float32,
                           device=p.device).index_add_(
            0, idx.clamp(0, num_classes - 1), weight * ok)

    ones = torch.ones(p.shape, dtype=torch.float32, device=p.device)
    inter = counts(p, (p == y).to(torch.float32))
    union = counts(p, ones) + counts(y, ones) - inter
    present = union > 0
    iou = torch.where(present, inter / union.clamp(min=1.0),
                      torch.zeros_like(union))
    miou = iou.sum() / present.sum().clamp(min=1)
    return miou, iou, present


def edit_distance(hyps, hyp_lens, refs, ref_lens, normalized=True):
    """Batch Levenshtein distance (operators/edit_distance_op.h): padded
    id arrays + lens; host-side DP like the reference CPU kernel.
    Returns (distances [B, 1] float32 tensor, sequence_num)."""
    h, r = _host(hyps), _host(refs)
    hl = _host(hyp_lens).ravel().astype(int)
    rl = _host(ref_lens).ravel().astype(int)
    out = np.zeros((len(hl), 1), np.float32)
    for b in range(len(hl)):
        a, bseq = h[b, :hl[b]], r[b, :rl[b]]
        n, m = len(a), len(bseq)
        d = np.arange(m + 1, dtype=np.int64)
        for i in range(1, n + 1):
            prev, d[0] = d[0], i
            for j in range(1, m + 1):
                cur = min(d[j] + 1, d[j - 1] + 1,
                          prev + (a[i - 1] != bseq[j - 1]))
                prev, d[j] = d[j], cur
        dist = float(d[m])
        out[b, 0] = dist / m if (normalized and m) else dist
    return torch.from_numpy(out), len(hl)


class ChunkEvaluator(Metric):
    """Chunking F1 for IOB / IOE / IOBES / plain tagging
    (operators/metrics/chunk_eval_op.h, host-side): update with padded tag
    ids + lens, accumulate (precision, recall, f1).

    Numeric tag scheme (the reference's): tag = chunk_type * num_tags +
    tag_role with num_tags = 2 for IOB (roles B,I) and IOE (roles I,E),
    4 for IOBES (roles B,I,E,S), 1 for plain; any tag >=
    num_tags * num_chunk_types (typically the next id) is Outside.
    Pass num_chunk_types (or a label_list of length
    num_tags*num_chunk_types + 1); without either, every tag is a
    chunk tag."""

    _ROLES = {"IOB": "BI", "IOE": "IE", "IOBES": "BIES", "IO": "I",
              "PLAIN": "S"}

    def __init__(self, label_list=None, scheme="IOB", name="chunk",
                 num_chunk_types=None, excluded_chunk_types=()):
        scheme = scheme.upper()
        if scheme not in self._ROLES:
            raise ValueError(
                f"chunk scheme {scheme!r}: one of IOB/IOE/IOBES/IO/plain")
        self._name = name
        self.label_list = label_list
        self.scheme = scheme
        self._ntags = len(self._ROLES[scheme])
        if num_chunk_types is None and label_list is not None:
            num_chunk_types = (len(label_list) - 1) // self._ntags
        self.num_chunk_types = num_chunk_types
        self.excluded = set(excluded_chunk_types)
        self.reset()

    def reset(self):
        self._correct = self._infer = self._label = 0

    def _decode(self, t):
        """tag id -> (chunk_type, role) or None for Outside."""
        if t < 0 or (self.num_chunk_types is not None
                     and t >= self._ntags * self.num_chunk_types):
            return None
        return t // self._ntags, self._ROLES[self.scheme][t % self._ntags]

    def _chunks(self, tags):
        """(type, start, end) chunks, conlleval-style: B/S (and a role that
        does not continue the open chunk) begin; E/S end; I continues."""
        chunks, start, ctype = [], None, None

        def flush(end):
            nonlocal start, ctype
            if start is not None and ctype not in self.excluded:
                chunks.append((ctype, start, end))
            start = ctype = None

        for i, t in enumerate(tags):
            d = self._decode(int(t))
            if d is None:
                flush(i)
                continue
            ty, role = d
            continues = (start is not None and ty == ctype
                         and role in ("I", "E"))
            if not continues:
                flush(i)
                start, ctype = i, ty
            if role in ("E", "S"):
                flush(i + 1)
        flush(len(tags))
        return set(chunks)

    def update(self, inferences, labels, seq_lens):
        inf, lab = _host(inferences), _host(labels)
        lens = _host(seq_lens).ravel().astype(int)
        for b, n in enumerate(lens):
            ci = self._chunks(inf[b, :n])
            cl = self._chunks(lab[b, :n])
            self._correct += len(ci & cl)
            self._infer += len(ci)
            self._label += len(cl)

    def accumulate(self):
        p = self._correct / self._infer if self._infer else 0.0
        r = self._correct / self._label if self._label else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


def _pairwise_iou(a, b):
    """[N,4] x [M,4] xyxy boxes -> [N,M] IoU (paddle_tpu/vision/ops.py
    ``_pairwise_iou_np``)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    ix = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    iy = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    ua = area_a[:, None] + area_b[None, :] - inter
    return np.where(ua > 0, inter / np.maximum(ua, 1e-12), 0.0)


class DetectionMAP(Metric):
    """VOC-style detection mAP (operators/detection_map_op.h, 11-point or
    integral): update with per-image detections and ground truth."""

    def __init__(self, overlap_threshold=0.5, ap_version="integral",
                 name="mAP"):
        self._name = name
        self.thresh = overlap_threshold
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = {}   # class -> list of (score, is_tp)
        self._npos = {}   # class -> gt count

    def update(self, det_boxes, det_scores, det_labels, gt_boxes,
               gt_labels):
        """One image: detections [N,4]/[N]/[N] + ground truth [M,4]/[M]."""
        db = _host(det_boxes).astype(np.float64).reshape(-1, 4)
        ds = _host(det_scores).astype(np.float64).ravel()
        dl = _host(det_labels).ravel().astype(int)
        gb = _host(gt_boxes).astype(np.float64).reshape(-1, 4)
        gl = _host(gt_labels).ravel().astype(int)
        for c in np.unique(gl):
            self._npos[int(c)] = self._npos.get(int(c), 0) + int(
                (gl == c).sum())
        for c in np.unique(dl):
            c = int(c)
            idx = np.where(dl == c)[0][np.argsort(-ds[dl == c])]
            taken = np.zeros(len(gb), bool)
            for i in idx:
                best, bj = 0.0, -1
                for j in np.where(gl == c)[0]:
                    v = float(_pairwise_iou(db[i], gb[j])[0, 0])
                    if v > best:
                        best, bj = v, j
                tp = best >= self.thresh and bj >= 0 and not taken[bj]
                if tp:
                    taken[bj] = True
                self._dets.setdefault(c, []).append((float(ds[i]), tp))

    def accumulate(self):
        aps = []
        for c, npos in self._npos.items():
            dets = sorted(self._dets.get(c, []), reverse=True)
            if not dets or npos == 0:
                aps.append(0.0)
                continue
            tp = np.cumsum([d[1] for d in dets])
            fp = np.cumsum([not d[1] for d in dets])
            rec = tp / npos
            prec = tp / np.maximum(tp + fp, 1e-12)
            if self.ap_version == "11point":
                ap = float(np.mean([
                    prec[rec >= t].max() if (rec >= t).any() else 0.0
                    for t in np.linspace(0, 1, 11)]))
            else:
                mrec = np.concatenate([[0], rec, [1]])
                mpre = np.concatenate([[0], prec, [0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(((mrec[idx + 1] - mrec[idx])
                            * mpre[idx + 1]).sum())
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


from . import metrics  # noqa: E402,F401  (the reference's submodule)
