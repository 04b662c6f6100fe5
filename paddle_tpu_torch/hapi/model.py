"""The high-level Model API (paddle_tpu/hapi/model.py; reference
python/paddle/hapi/model.py: Model.fit:1052, evaluate:1750,
predict:1999): prepare, fit, evaluate, predict, the batch steps, save,
load and summary, eager. Inputs and labels become Tensors on the default
place (a model on the card is fed from host data through io.DataLoader);
each train batch reads its loss back to the host, as the reference does.
Under an initialized world of more than one rank, ``prepare`` wraps the
network in distributed.DataParallel and ``fit`` shards the data with a
DistributedBatchSampler."""
from __future__ import annotations

import numpy as np

from ..core.autograd import no_grad
from ..core.tensor import Tensor
from ..io import DataLoader
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._ddp = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        # distributed-aware fit (reference DynamicGraphAdapter: under a
        # multi-process launch the network trains through DataParallel —
        # grads allreduce over the transport — while save/state_dict
        # keep addressing the inner network). Wrap once: re-preparing
        # (e.g. to swap optimizers) must not re-register grad hooks.
        from .. import distributed as dist

        if self._ddp is None and dist.is_initialized() \
                and dist.get_world_size() > 1:
            self._ddp = dist.parallel.DataParallel(self.network)
        return self

    @property
    def _train_network(self):
        return self._ddp if self._ddp is not None else self.network

    # -- core steps ---------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        net = self._train_network
        net.train()
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        outputs = net(*[self._t(x) for x in inputs])
        losses = self._compute_loss(outputs, labels)
        total = losses if isinstance(losses, Tensor) else sum(losses)
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        loss_val = [float(total.numpy())]
        return (loss_val, metrics) if metrics else loss_val

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        outputs = self.network(*[self._t(x) for x in inputs])
        losses = self._compute_loss(outputs, labels) if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        if losses is not None:
            total = losses if isinstance(losses, Tensor) else sum(losses)
            return [float(total.numpy())], metrics
        return metrics

    @no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = _to_list(inputs)
        outputs = self.network(*[self._t(x) for x in inputs])
        outs = _to_list(outputs)
        return [o.numpy() for o in outs]

    def _t(self, x):
        return x if isinstance(x, Tensor) else Tensor(np.asarray(x))

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            return outputs if isinstance(outputs, Tensor) else outputs[0]
        outs = _to_list(outputs)
        labs = [self._t(l) for l in labels]
        return self._loss(*(outs + labs))

    def _update_metrics(self, outputs, labels):
        outs = _to_list(outputs)
        labs = [self._t(l) for l in labels]
        results = []
        for metric in self._metrics:
            computed = metric.compute(*(outs + labs))
            r = metric.update(*_to_list(computed))
            results.append(r)
        return results

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        dist_sampler = None
        if not isinstance(train_data, DataLoader):
            if self._ddp is not None:
                # shard the dataset across ranks (reference fit uses
                # DistributedBatchSampler under a parallel env)
                from ..io import DistributedBatchSampler

                dist_sampler = DistributedBatchSampler(
                    train_data, batch_size=batch_size, shuffle=shuffle,
                    drop_last=drop_last)
                train_loader = DataLoader(train_data,
                                          batch_sampler=dist_sampler,
                                          num_workers=num_workers)
            else:
                train_loader = DataLoader(train_data,
                                          batch_size=batch_size,
                                          shuffle=shuffle,
                                          drop_last=drop_last,
                                          num_workers=num_workers)
        else:
            train_loader = train_data
            dist_sampler = getattr(train_loader, "batch_sampler", None)
            if not hasattr(dist_sampler, "set_epoch"):
                dist_sampler = None
        eval_loader = None
        if eval_data is not None:
            eval_loader = eval_data if isinstance(eval_data, DataLoader) \
                else DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            metrics=["loss"] + [
                                n for m in self._metrics
                                for n in _to_list(m.name())],
                            log_freq=log_freq)
        cbks.on_begin("train")
        steps = None
        try:
            steps = len(train_loader)
        except Exception:
            pass
        for epoch in range(epochs):
            if self.stop_training:
                break
            for m in self._metrics:
                m.reset()
            if dist_sampler is not None:
                # fresh per-epoch shuffle order across ranks
                dist_sampler.set_epoch(epoch)
            cbks.on_epoch_begin(epoch, {"steps": steps})
            logs = {}
            for step, batch in enumerate(train_loader):
                if num_iters is not None and step >= num_iters:
                    break
                cbks.on_batch_begin("train", step, logs)
                ins, labs = self._split_batch(batch)
                out = self.train_batch(ins, labs)
                logs = self._pack_logs(out)
                logs["batch_size"] = (
                    ins[0].shape[0] if hasattr(ins[0], "shape") else None)
                cbks.on_batch_end("train", step, logs)
            if hasattr(self._optimizer, "_learning_rate") and hasattr(
                    self._optimizer._learning_rate, "step"):
                self._optimizer._learning_rate.step()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({"eval_" + k: v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
        cbks.on_end("train", logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            ins, labs = self._split_batch(batch)
            out = self.eval_batch(ins, labs)
            if isinstance(out, tuple) and self._loss:
                losses.append(out[0][0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            for name, val in zip(_to_list(m.name()),
                                 _to_list(m.accumulate())):
                logs[name] = val
        if verbose:
            print("Eval:", " - ".join(f"{k}: {v:.4f}" for k, v in
                                      logs.items()))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                return _to_list(batch[0]), _to_list(batch[1])
            return _to_list(batch[0]), []
        return [batch], []

    def _pack_logs(self, out):
        logs = {}
        if isinstance(out, tuple):
            losses, metrics = out
            logs["loss"] = losses[0]
            i = 0
            for m in self._metrics:
                for name, val in zip(_to_list(m.name()),
                                     _to_list(metrics[i])):
                    logs[name] = float(val)
                i += 1
        else:
            logs["loss"] = out[0]
        return logs

    # -- io ------------------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save as fsave

        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload

        state = fload(path + ".pdparams")
        self.network.set_state_dict(state)
        if not reset_optimizer and self._optimizer is not None:
            import os

            if os.path.exists(path + ".pdopt"):
                self._optimizer.set_state_dict(fload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary

        return _summary(self.network, input_size, dtype)
