"""``paddle.metric`` of the port (a port of ``paddle_tpu/metric``):
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the
functional ``accuracy``. The classes accumulate on the host in numpy, as
the reference's do; ``accuracy`` runs the port's ops."""
import numpy as np

from ..core.tensor import Tensor


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pv = pred.numpy() if isinstance(pred, Tensor) else np.asarray(pred)
        lv = label.numpy() if isinstance(label, Tensor) else np.asarray(label)
        if lv.ndim == pv.ndim and lv.shape[-1] == 1:
            lv = lv.squeeze(-1)
        idx = np.argsort(-pv, axis=-1)[..., :self.maxk]
        correct = (idx == lv[..., None])
        return Tensor(correct.astype(np.float32))

    def update(self, correct, *args):
        cv = correct.numpy() if isinstance(correct, Tensor) else np.asarray(correct)
        num = cv.shape[0] if cv.ndim > 0 else 1
        res = []
        for k in self.topk:
            c = cv[..., :k].sum()
            self.total[self.topk.index(k)] += c
            self.count[self.topk.index(k)] += num
            res.append(float(c) / num if num else 0.0)
        return res[0] if len(res) == 1 else res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        pv = preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)
        lv = labels.numpy() if isinstance(labels, Tensor) else np.asarray(labels)
        pred_pos = (pv > 0.5).reshape(-1)
        lab = lv.reshape(-1).astype(bool)
        self.tp += int((pred_pos & lab).sum())
        self.fp += int((pred_pos & ~lab).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        den = self.tp + self.fp
        return float(self.tp) / den if den else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        pv = preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)
        lv = labels.numpy() if isinstance(labels, Tensor) else np.asarray(labels)
        pred_pos = (pv > 0.5).reshape(-1)
        lab = lv.reshape(-1).astype(bool)
        self.tp += int((pred_pos & lab).sum())
        self.fn += int((~pred_pos & lab).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        den = self.tp + self.fn
        return float(self.tp) / den if den else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        pv = preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)
        lv = labels.numpy() if isinstance(labels, Tensor) else np.asarray(labels)
        if pv.ndim == 2 and pv.shape[1] == 2:
            pv = pv[:, 1]
        pv = pv.reshape(-1)
        lv = lv.reshape(-1)
        bins = np.minimum((pv * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        for b, l in zip(bins, lv):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = float(self._stat_pos.sum())
        tot_neg = float(self._stat_neg.sum())
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds from high to low
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """The share of rows whose label is among the top ``k`` of
    ``input`` (``correct``, ``total`` taken and not read)."""
    from .. import ops
    topk_vals, topk_idx = ops.search.topk(input, k)
    lv = label
    if lv.ndim == 1:
        lv = ops.manipulation.unsqueeze(lv, axis=-1)
    correct_mat = ops.logic.equal(topk_idx, ops.math.cast(lv, topk_idx._v.dtype))
    acc = ops.reduction.mean(
        ops.reduction.max(ops.math.cast(correct_mat, "float32"), axis=-1))
    return acc
