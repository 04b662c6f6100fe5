"""paddle.metric (paddle_tpu/metric/__init__.py): Accuracy, Precision,
Recall and Auc, which accumulate on the host in numpy, and ``accuracy``,
an op on the tensors' device."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


class Metric:
    def __init__(self):
        pass

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
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = pred.numpy() if isinstance(pred, Tensor) else np.asarray(pred)
        l = label.numpy() if isinstance(label, Tensor) else np.asarray(label)
        if l.ndim == p.ndim and l.shape[-1] > 1:  # one-hot
            l = l.argmax(-1)
        l = l.reshape(-1)
        topk_idx = np.argsort(-p, axis=-1)[..., : self.maxk].reshape(
            -1, self.maxk)
        correct = topk_idx == l[:, None]
        return Tensor(correct.astype(np.float32))

    def update(self, correct, *args):
        c = correct.numpy() if isinstance(correct, Tensor) else \
            np.asarray(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = c[:, :k].sum()
            self.total[i] += num
            self.count[i] += c.shape[0]
            accs.append(num / c.shape[0])
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        out = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return out[0] if len(out) == 1 else out

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (preds.numpy() if isinstance(preds, Tensor)
             else np.asarray(preds)).reshape(-1)
        l = (labels.numpy() if isinstance(labels, Tensor)
             else np.asarray(labels)).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fp += int(np.sum(pred_pos & (l == 0)))

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (preds.numpy() if isinstance(preds, Tensor)
             else np.asarray(preds)).reshape(-1)
        l = (labels.numpy() if isinstance(labels, Tensor)
             else np.asarray(labels)).reshape(-1)
        pred_pos = p > 0.5
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fn += int(np.sum(~pred_pos & (l == 1)))

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = preds.numpy() if isinstance(preds, Tensor) else np.asarray(preds)
        l = (labels.numpy() if isinstance(labels, Tensor)
             else np.asarray(labels)).reshape(-1)
        pos_prob = p[:, 1] if p.ndim == 2 else p.reshape(-1)
        bins = np.round(pos_prob * self.num_thresholds).astype(int)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            area += self._stat_pos[i] * (neg + self._stat_neg[i] / 2)
            pos += self._stat_pos[i]
            neg += self._stat_neg[i]
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top ``k`` (a stable
    sort, as jnp.argsort), f32."""
    from ..core.dispatch import apply

    def fn(p, l):
        topk = torch.argsort(-p, dim=-1, stable=True)[..., :k]
        c = (topk == l.reshape(-1, 1)).any(dim=-1)
        return c.float().mean()
    return apply(fn, input, label, op_name="accuracy", differentiable=False)
