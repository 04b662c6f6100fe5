"""Training callbacks (paddle_tpu/hapi/callbacks.py; reference
python/paddle/hapi/callbacks.py): plain Python, copied as it is."""
from __future__ import annotations

import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, verbose=2, metrics=None,
                 log_freq=10):
        self.callbacks = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger)
                               for c in self.callbacks):
            self.callbacks.insert(0, ProgBarLogger(log_freq, verbose))
        for c in self.callbacks:
            c.set_model(model)
            c.set_params({"metrics": metrics or [], "verbose": verbose})

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)
        if mode == "train":
            self._call("on_train_begin", logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)
        if mode == "train":
            self._call("on_train_end", logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)
        if mode == "train":
            self._call("on_train_batch_begin", step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)
        if mode == "train":
            self._call("on_train_batch_end", step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._t0 = None
        self._count = 0

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.perf_counter()
        self._count = 0
        self.steps = (logs or {}).get("steps")

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train" or not self.verbose:
            return
        logs = logs or {}
        bs = logs.get("batch_size") or 1
        self._count += bs
        if (step + 1) % self.log_freq == 0:
            dt = time.perf_counter() - self._t0
            ips = self._count / max(dt, 1e-9)
            items = " - ".join(
                f"{k}: {v:.4f}" for k, v in logs.items()
                if isinstance(v, (int, float)) and k != "batch_size")
            total = f"/{self.steps}" if self.steps else ""
            eta = ""
            if self.steps:
                remaining = max(self.steps - (step + 1), 0)
                eta_s = remaining * dt / (step + 1)
                eta = f" - ETA: {int(eta_s // 60):d}:{int(eta_s % 60):02d}"
            print(f"Epoch {self.epoch} step {step + 1}{total}: {items}"
                  f" - {ips:.1f} samples/s{eta}")

    def on_epoch_end(self, epoch, logs=None):
        if not self.verbose:
            return
        logs = logs or {}
        items = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items()
                           if isinstance(v, (int, float))
                           and k != "batch_size")
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        print(f"Epoch {epoch} done ({dt:.1f}s): {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_end(self, mode, logs=None):
        if mode == "train" and self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda a, b: a > b + self.min_delta
            self.best = -np.inf
        else:
            self.better = lambda a, b: a < b - self.min_delta
            self.best = np.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor) or logs.get("eval_" + self.monitor)
        if cur is None:
            return
        if self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()
