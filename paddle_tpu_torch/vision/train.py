"""The ResNet train step: forward, backward and momentum SGD over fp32
masters (the port of bench.py:1069-1146 `bench_resnet50`'s step).

    model = models.resnet50()                      # on cuda, train() mode
    step_fn, state = build_train_step(model)       # bf16 over fp32 masters
    state, loss = step_fn(state, images, labels)   # NCHW images, int labels
"""

from __future__ import annotations

import torch
from torch import nn

from .. import device as _device
from ..jit import functional_call, functional_state


def resnet50_fwd_flops(batch, hw, classes):
    """Analytic ResNet-50 v1 forward: ~4.1 GMACs at 224^2 (scaling with the
    spatial area), 2 flops a MAC, plus the fc head (bench.py:869-873)."""
    base = 4.1e9 * 2.0 * (hw / 224.0) ** 2
    return batch * (base + 2 * 2048 * classes)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    """A 4-D tensor on the card in channels_last (its shape unchanged)."""
    if t.is_cuda and t.ndim == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t


def build_train_step(model: nn.Module, lr=0.1, momentum=0.9, bf16=True,
                     device=None):
    """Returns (step_fn, state).

    state = {"params": fp32 masters of every parameter and buffer by name
    (BN's `_mean` / `_variance` included), "vel": a velocity for each
    parameter (none for buffers)}; step_fn(state, x, y) -> (state, loss)
    with x (B, C, H, W) images and y (B,) class ids, as tensors or numpy.

    The forward runs through `jit.functional_call` on a bf16 cast of the
    fp32 parameters (with `bf16`; buffers stay f32), in the model's
    current mode (train() by default, so BN updates the master running
    statistics in place).  loss = -mean(log_softmax(logits.float())[y]);
    then vel = momentum * vel + g and p -= lr * vel.  The step UPDATES
    `state` IN PLACE and returns it with the loss, a 0-d tensor on the
    device: nothing reads a device value back to the host.  On the card,
    images and 4-D masters are channels_last."""
    dev = (next(iter(model.parameters())).device if device is None
           else _device.resolve(device))
    buffers = {name for name, _ in model.named_buffers()}
    params = {k: _on_card(v.to(dev, torch.float32, copy=True))
              for k, v in functional_state(model).items()}
    names = [k for k in params if k not in buffers]
    state = {"params": params,
             "vel": {k: torch.zeros_like(params[k]) for k in names}}

    def step_fn(state, x, y):
        x = _on_card(torch.as_tensor(x).to(
            dev, torch.bfloat16 if bf16 else torch.float32))
        y = torch.as_tensor(y).to(dev, torch.int64)
        leaves = [state["params"][k].detach().requires_grad_(True)
                  for k in names]
        cast = {k: v.to(torch.bfloat16) if bf16 else v
                for k, v in zip(names, leaves)}
        cast.update({k: state["params"][k] for k in buffers})
        logits, _ = functional_call(model, cast, x)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
        grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
        vel = [state["vel"][k] for k in names]
        with torch.no_grad():
            torch._foreach_mul_(vel, momentum)
            torch._foreach_add_(vel, grads)
            torch._foreach_add_([state["params"][k] for k in names], vel,
                                alpha=-lr)
        return state, loss.detach()

    return step_fn, state
