"""hapi `Model`: prepare / fit / evaluate / predict / save / load
(counterpart of paddle_tpu/hapi/model.py).

Two adapters, chosen as the reference chooses them: outside
`fluid.dygraph.guard()` (the default) the static-mode adapter, inside it
the dygraph one.

The static-mode adapter runs one train step over `jit.functional_call`
with the Layer's float32 parameters as masters.  Under `amp_configs` O1
or O2 every float32 parameter and input is cast to bfloat16 for the
forward (buffers stay float32), the loss is scaled by a fixed factor
(32768 unless `init_loss_scaling` says otherwise) and the gradients are
unscaled in float32; a gradient that is not finite leaves the
parameters and the optimizer state as they were, decided on the device
(`torch.where`), with no host read.

The dygraph adapter runs the network eagerly: under O1 / O2 inside
`amp.auto_cast` (the reference's op lists) with a dynamic `GradScaler`.

A train step reads two values back to the host: the loss, which the
logs carry as a float, and, with `metric.Accuracy`, the top-k hits.
The static-mode adapter accumulates its host time by stage on
`profiler.get_time_stats()`: hapi_forward, hapi_backward, hapi_update
(issuing the work; the device runs behind) and hapi_metrics (which
waits for the device at its first read).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import profiler as _profiler
from ..fluid import framework as _framework
from ..fluid.dygraph import guard
from ..jit import functional_call
from .callbacks import CallbackList, ProgBarLogger


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _device_of(net):
    for p in net.parameters():
        return p.device
    return torch.device("cpu")


def _on(dev, v, low=None):
    """v (numpy or a tensor) on `dev`; a float32 one in `low` when given;
    a 4-D one channels_last on the card, as the models' weights are."""
    t = torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v))
    t = t.to(dev, non_blocking=True)
    if low is not None and t.dtype == torch.float32:
        t = t.to(low)
    if t.is_cuda and t.ndim == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _loss_value(loss):
    return loss[0] if isinstance(loss, (list, tuple)) else loss


def _host(o):
    o = o.detach()
    return (o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()


class _StaticGraphAdapter:
    """The reference's static-mode adapter (hapi/model.py:30): the whole
    step, forward, loss, gradients and the optimizer's update, as one
    function of the parameters.  Only the train step differs between
    the adapters: evaluation and prediction are the Model's own."""

    def __init__(self, model):
        self.model = model

    def _amp_level(self):
        cfg = self.model._amp_configs
        if not cfg:
            return "O0", 1.0
        if isinstance(cfg, str):
            return cfg.upper(), 32768.0
        return (str(cfg.get("level", "O1")).upper(),
                float(cfg.get("init_loss_scaling", 32768.0)))

    def train_batch(self, inputs, labels=None):
        model = self.model
        net, loss_l, opt = model.network, model._loss, model._optimizer
        net.train()
        level, loss_scale = self._amp_level()
        amp = level in ("O1", "O2")
        low = torch.bfloat16 if amp else None
        named = [(n, p) for n, p in net.named_parameters()
                 if getattr(p, "trainable", p.requires_grad)]
        names = [n for n, _ in named]
        params = [p for _, p in named]
        dev = _device_of(net)
        with _profiler.timed("hapi_forward"):
            ins = [_on(dev, v, low) for v in _to_list(inputs)]
            labs = [_on(dev, v) for v in _to_list(labels)]
            leaves = [p.detach().requires_grad_(True) for p in params]
            fwd = {n: (v.to(low) if amp and v.dtype == torch.float32 else v)
                   for n, v in zip(names, leaves)}
            out, _ = functional_call(net, fwd, *ins)
            outs = _to_list(out)
            loss = _loss_value(loss_l(*(outs + labs))).float()
        with _profiler.timed("hapi_backward"):
            grads = list(torch.autograd.grad(
                loss * loss_scale if amp else loss, leaves))
        with torch.no_grad(), _profiler.timed("hapi_update"):
            if amp:
                grads = [g if g.dtype == torch.float32 else g.float()
                         for g in grads]
                torch._foreach_div_(grads, loss_scale)
            if opt._grad_clip is not None:
                order = sorted(range(len(names)), key=names.__getitem__)
                clipped = opt._grad_clip._apply([grads[i] for i in order])
                for i, g in zip(order, clipped):
                    grads[i] = g
            finite = torch.isfinite(torch.stack(
                torch._foreach_norm(grads, float("inf")))).all()
            opt._step_count += 1
            old = {k: [opt._param_state(p)[k] for p in params]
                   for k in opt._param_state(params[0])}
            new_p, new_s = opt._apply(params, grads, params, opt.get_lr(),
                                      opt._step_count)
            # a gradient that is not finite skips the update: each live
            # tensor takes its new value, or keeps its own, in place
            for a, p in zip(new_p, params):
                torch.where(finite, a, p.data, out=p.data)
            for k, vals in new_s.items():
                for a, b in zip(vals, old[k]):
                    torch.where(finite, a, b, out=b)
        with _profiler.timed("hapi_metrics"):
            metrics = model._update_metrics([o.detach() for o in outs], labs)
        return [loss.item()], metrics


class Model:
    """Model(network) -> prepare(optimizer, loss, metrics, amp_configs)
    -> fit / evaluate / predict, save / load."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_configs = None
        self._input_specs = inputs
        self._label_specs = labels
        self._adapter = None if _framework.in_dygraph_mode() \
            else _StaticGraphAdapter(self)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._amp_configs = amp_configs
        return self

    # -- steps -------------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        if self._adapter is not None:
            return self._adapter.train_batch(inputs, labels)
        from .. import amp as pamp

        self.network.train()
        dev = _device_of(self.network)
        inputs = [_on(dev, v) for v in _to_list(inputs)]
        labels = [_on(dev, v) for v in _to_list(labels)]
        level = None
        if self._amp_configs:
            level = (self._amp_configs if isinstance(self._amp_configs, str)
                     else self._amp_configs.get("level", "O1"))
        if level and str(level).upper() in ("O1", "O2"):
            if not hasattr(self, "_scaler"):
                init = 32768.0
                if isinstance(self._amp_configs, dict):
                    init = float(self._amp_configs.get("init_loss_scaling",
                                                       init))
                self._scaler = pamp.GradScaler(init_loss_scaling=init)
            # auto_cast's default level (O1), whatever amp_configs says,
            # as in the reference
            with pamp.auto_cast(True):
                outs = _to_list(self.network(*inputs))
                loss = _loss_value(self._loss(*(outs + labels)))
            scaled = self._scaler.scale(loss)
            scaled.backward()
            self._scaler.minimize(self._optimizer, scaled)
        else:
            outs = _to_list(self.network(*inputs))
            loss = _loss_value(self._loss(*(outs + labels)))
            loss.backward()
            self._optimizer.step()
        self._optimizer.clear_grad()
        metrics = self._update_metrics([o.detach() for o in outs], labels)
        return [loss.item()], metrics

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = _device_of(self.network)
        inputs = [_on(dev, v) for v in _to_list(inputs)]
        labels = [_on(dev, v) for v in _to_list(labels)]
        with torch.no_grad():
            outs = _to_list(self.network(*inputs))
            loss = _loss_value(self._loss(*(outs + labels))) \
                if self._loss is not None else None
        metrics = self._update_metrics(outs, labels)
        return ([loss.item()] if loss is not None else []), metrics

    def predict_batch(self, inputs):
        self.network.eval()
        dev = _device_of(self.network)
        with torch.no_grad():
            outs = self.network(*[_on(dev, v) for v in _to_list(inputs)])
        return [_host(o) for o in _to_list(outs)]

    def _update_metrics(self, outs, labels):
        res = {}
        for m in self._metrics:
            m.update(m.compute(outs[0], *labels))
            names, vals = m.name(), m.accumulate()
            if isinstance(names, str):
                names, vals = [names], [vals]
            elif not isinstance(vals, (list, tuple)):
                vals = [vals]
            res.update(dict(zip(names, vals)))
        return res

    # -- loops -------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 drop_last, num_workers)
        eval_loader = self._as_loader(eval_data, batch_size, False, False,
                                      0) if eval_data is not None else None
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbs = _to_list(callbacks) or [ProgBarLogger(log_freq, verbose)]
        cblist = CallbackList(cbs, model=self,
                              params={"epochs": epochs, "steps": steps,
                                      "verbose": verbose})
        self.stop_training = False
        with guard():
            cblist.on_train_begin()
            history = []
            for epoch in range(epochs):
                for m in self._metrics:
                    m.reset()
                cblist.on_epoch_begin(epoch)
                logs = {}
                for step, batch in enumerate(loader):
                    cblist.on_train_batch_begin(step)
                    ins, labs = self._split_batch(batch)
                    losses, metrics = self.train_batch(ins, labs)
                    logs = {"loss": losses[0], **metrics}
                    cblist.on_train_batch_end(step, logs)
                cblist.on_epoch_end(epoch, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(
                        eval_loader, batch_size=batch_size, verbose=0,
                        _prepared=True)
                    cblist.on_eval_end(eval_logs)
                history.append(logs)
                if save_dir and (epoch + 1) % save_freq == 0:
                    self.save(os.path.join(save_dir, str(epoch)))
                if self.stop_training:
                    break
            cblist.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None, _prepared=False):
        loader = eval_data if _prepared else self._as_loader(
            eval_data, batch_size, False, False, num_workers)
        for m in self._metrics:
            m.reset()
        metrics = {}
        with guard():
            losses = []
            for batch in loader:
                ins, labs = self._split_batch(batch)
                lv, metrics = self.eval_batch(ins, labs)
                losses.extend(lv)
        logs = dict(metrics) if self._metrics else {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None):
        import inspect

        loader = self._as_loader(test_data, batch_size, False, False,
                                 num_workers)
        # datasets often yield (inputs..., label): forward() takes as many
        # positional inputs as it declares
        sig = inspect.signature(self.network.forward)
        n_in = sum(1 for p in sig.parameters.values()
                   if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                   and p.default is p.empty)
        outs = []
        with guard():
            for batch in loader:
                ins, _ = self._split_batch(batch, has_label=False)
                outs.append(self.predict_batch(ins[:n_in] if n_in else ins))
        if stack_outputs and outs:
            return [np.concatenate([o[i] for o in outs])
                    for i in range(len(outs[0]))]
        return outs

    # -- helpers -----------------------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, drop_last, num_workers):
        from .. import io as pio

        if data is None:
            return None
        if isinstance(data, pio.DataLoader):
            return data
        if isinstance(data, pio.Dataset):
            return pio.DataLoader(data, batch_size=batch_size,
                                  shuffle=shuffle, drop_last=drop_last,
                                  num_workers=num_workers,
                                  use_buffer_reader=False)
        return data  # any iterable of batches

    @staticmethod
    def _split_batch(batch, has_label=True):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if not has_label or len(batch) == 1:
            return batch, []
        return batch[:-1], batch[-1:]

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from ..framework_io import save as psave

        psave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            psave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework_io import load as pload

        self.network.set_state_dict(pload(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(pload(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        print(f"{self.network!r}\nTotal params: {n_params}")
        return {"total_params": n_params}


def summary(net, input_size=None, dtypes=None):
    """A table of the sublayers and their parameter counts (paddle.summary)."""
    rows, total, trainable = [], 0, 0
    for name, sub in [("", net)] + list(net.named_sublayers()):
        ps = list(sub.parameters(recurse=False))
        n = sum(p.numel() for p in ps)
        if name:
            rows.append((name, type(sub).__name__, n))
        total += n
        trainable += sum(p.numel() for p in ps if p.requires_grad)
    width = max([len(r[0]) for r in rows], default=10) + 2
    print(f"{'Layer':<{width}}{'Type':<24}{'Params':>12}")
    for name, t, n in rows:
        print(f"{name:<{width}}{t:<24}{n:>12}")
    print(f"Total params: {total}")
    print(f"Trainable params: {trainable}")
    print(f"Non-trainable params: {total - trainable}")
    return {"total_params": int(total), "trainable_params": int(trainable)}
