"""hapi callbacks (a copy of paddle_tpu/hapi/callbacks.py): Callback,
ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler."""

from __future__ import annotations

import os
import time

import numpy as np


class Callback:
    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model=None, params=None):
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.set_params(params)
            if model is not None:
                cb.set_model(model)

    def __getattr__(self, name):
        def call(*args, **kw):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kw)

        return call


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and (step + 1) % self.log_freq == 0:
            items = " - ".join(f"{k}: {_fmt(v)}" for k, v in logs.items())
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step + 1}{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.verbose:
            items = " - ".join(f"{k}: {_fmt(v)}" for k, v in logs.items())
            dt = time.time() - self._t0
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {items}")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            items = " - ".join(f"{k}: {_fmt(v)}" for k, v in logs.items())
            print(f"Eval - {items}")


def _fmt(v):
    try:
        arr = np.asarray(v).reshape(-1)
        return f"{float(arr[0]):.4f}"
    except Exception:
        return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda a, b: a > b + self.min_delta
            self.best = -np.inf
        else:
            self.better = lambda a, b: a < b - self.min_delta
            self.best = np.inf
        if baseline is not None:
            self.best = baseline

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        current = float(np.asarray(logs[self.monitor]).reshape(-1)[0])
        if self.better(current, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference: callbacks.py
    LRScheduler — by_step/by_epoch)."""

    def __init__(self, by_step=False, by_epoch=True):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()
