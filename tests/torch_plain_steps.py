"""A plain O1 Momentum step, written out, to hold the port's
`hapi.Model.train_batch` at amp O1 against, on the CPU
(tests/test_torch_hapi_resnet.py) and on the card
(tests/test_torch_cuda.py).  It imports no JAX."""

import contextlib

import numpy as np
import torch

import paddle_tpu_torch as T
from paddle_tpu_torch.fluid import dygraph as Tdy
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.vision import models as TM


def _input(x, dev, low=None):
    t = torch.from_numpy(x).to(dev)
    if low is not None:
        t = t.to(low)
    if t.is_cuda and t.ndim == 4:  # the models' weights are channels_last
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def plain_o1(adapter, net, batches, scale, lr=0.01, mu=0.9, wd=1e-4):
    """Momentum steps at O1 written out, from net's weights: float32
    masters; the forward with every parameter cast to bfloat16
    (static-mode) or under the port's auto_cast (dygraph); the loss
    scaled, the gradients unscaled in float32; coupled L2, then the
    velocity.  Returns the losses and the state after, in numpy."""
    dev = next(iter(net.parameters())).device
    masters = {n: p.detach().clone() for n, p in net.named_parameters()}
    vel = {n: torch.zeros_like(p) for n, p in masters.items()}
    params = dict(net.named_parameters())
    losses = []
    net.train()
    for x, y in batches:
        y = torch.from_numpy(y).to(dev)
        for n, p in params.items():
            p.data = masters[n].to(torch.bfloat16 if adapter == "static"
                                   else torch.float32)
            p.grad = None
        if adapter == "static":
            loss = T.nn.CrossEntropyLoss()(
                net(_input(x, dev, torch.bfloat16)), y).float()
        else:
            with T.amp.auto_cast(True):
                loss = T.nn.CrossEntropyLoss()(net(_input(x, dev)), y)
        (loss * scale).backward()
        for n, p in params.items():
            g = p.grad.float() / scale + wd * masters[n]
            vel[n] = mu * vel[n] + g
            masters[n] = masters[n] - lr * vel[n]
        losses.append(float(loss.detach()))
    for n, p in params.items():
        p.data = masters[n]
    return losses, {k: v.detach().float().cpu().numpy()
                    for k, v in net.state_dict().items()}


def resnet18_o1_steps(adapter, dev, shape, batch=4, steps=2):
    """resnet18 (10 classes) from one set of weights, `steps` batches of
    `shape` images through Model.train_batch at O1 (Momentum 0.01, 0.9,
    L2 1e-4) and through plain_o1.  Returns the model's state and the
    plain one's, both sets of losses, and each tensor's change's relative
    L2 error against the plain one."""
    rng = np.random.RandomState(0)
    batches = [(rng.randn(batch, *shape).astype(np.float32),
                rng.randint(0, 10, (batch, 1)).astype(np.int64))
               for _ in range(steps)]
    nets = []
    for _ in range(2):
        with TU.guard():
            nets.append(TM.resnet18(num_classes=10, device=dev))
    net, plain_net = nets
    before = {k: v.detach().float().cpu().numpy().copy()
              for k, v in net.state_dict().items()}
    assert plain_net.set_state_dict(before) == ([], [])
    want_losses, want = plain_o1(adapter, plain_net, batches, 32768.0)
    ctx = Tdy.guard if adapter == "dygraph" else contextlib.nullcontext
    with ctx():
        model = T.Model(net)
    model.prepare(T.optimizer.Momentum(0.01, 0.9, parameters=net.parameters(),
                                       weight_decay=1e-4),
                  T.nn.CrossEntropyLoss(), amp_configs="O1")
    with ctx():
        losses = [model.train_batch([x], [y])[0][0] for x, y in batches]
    got = {k: v.detach().float().cpu().numpy()
           for k, v in net.state_dict().items()}
    errs = {}
    for k, w in want.items():
        d = np.linalg.norm(w - before[k])
        assert d > 0, k
        errs[k] = float(np.linalg.norm(got[k] - w) / d)
    return got, want, losses, want_losses, errs
