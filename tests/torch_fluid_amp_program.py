"""BASELINE configs[1]'s static ResNet-50 program trained the way Paddle's
fleet trains it with its AMP and LARS meta-optimizers, written once
against the `fluid` (and the `models.resnet`) of the package passed in,
so the CPU tests build it with both packages and `chip_smoke.py` runs it
on the card.  It imports neither package itself.

- `amp_optimizer`: `fluid.contrib.mixed_precision.decorate(
  LarsMomentumOptimizer(lr, **LARS), dtype="float16", **AMP)`, where LARS
  and AMP are the fleet's `lars_configs` and `amp_configs` defaults
  (paddle_tpu/distributed/fleet/base/distributed_strategy.py); float16
  with dynamic loss scaling is the static AMP that Paddle runs on NVIDIA
  cards.
- `build`: `models/resnet.build_train_program` with that optimizer (its
  `optimizer=` argument; the model code is untouched).
- `recompute_optimizer`: RecomputeOptimizer over an inner optimizer, its
  checkpoints the outputs of the residual blocks (each block's closing
  relu over the shortcut sum: 16 for ResNet-50), found when minimize
  runs.
- `amp_state_names`: the loss-scaling var, the good and bad step counts
  and the found-overflow flag, to fetch.
- `replay_loss_scaling`: the update_loss_scaling rule in numpy over the
  fetched flags, the oracle of the scale's trajectory.
"""

import numpy as np

# fleet's amp_configs (distributed_strategy.py:31-35) with fp16
AMP = dict(init_loss_scaling=32768.0, incr_every_n_steps=1000,
           decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
           use_dynamic_loss_scaling=True)
# fleet's lars_configs (distributed_strategy.py:66)
LARS = dict(momentum=0.9, lars_coeff=0.001, lars_weight_decay=0.0005)
# LARS scales each layer's step by lars_coeff ||w|| / ||g||, so its base
# rate is that of a trust ratio: a few, where Momentum's is 0.1
LR = 2.0


def amp_optimizer(fluid, lr=LR, dtype="float16"):
    return fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.LarsMomentumOptimizer(lr, **LARS), dtype=dtype,
        **AMP)


def build(fluid, R, unique_name, optimizer, depth=50, class_num=1000,
          image_shape=(3, 224, 224), batch_size=128, width=64):
    """(main, startup, feed names, [avg_loss, acc]) of the train program
    with `optimizer` (its minimize appends the backward and update)."""
    with unique_name.guard():
        return R.build_train_program(
            depth=depth, class_num=class_num, image_shape=image_shape,
            batch_size=batch_size, width=width, optimizer=optimizer)


def block_outputs(block):
    """The residual blocks' outputs: each relu whose input is the
    shortcut sum (an elementwise_add)."""
    made_by = {n: op for op in block.ops for n in op.output_arg_names()}
    out = []
    for op in block.ops:
        if op.type != "relu":
            continue
        src = made_by.get(op.input("X")[0])
        if src is not None and src.type == "elementwise_add":
            out.append(op.output("Out")[0])
    return out


def recompute_optimizer(fluid, inner):
    """RecomputeOptimizer over `inner`, checkpointed at the residual
    blocks' outputs of the program its minimize is called on."""
    opt = fluid.optimizer.RecomputeOptimizer(inner)
    minimize = opt.minimize

    def minimize_at_blocks(loss, *args, **kwargs):
        opt._set_checkpoints(block_outputs(loss.block))
        return minimize(loss, *args, **kwargs)

    opt.minimize = minimize_at_blocks
    return opt


def amp_state_names(main, decorated):
    """(loss scaling, good steps, bad steps, found-overflow flag)
    var names of a decorated program."""
    found = next(op.output("FoundInfinite")[0]
                 for op in main.global_block().ops
                 if op.type == "check_finite_and_unscale")
    return (decorated.get_loss_scaling().name, decorated._good_steps.name,
            decorated._bad_steps.name, found)


def replay_loss_scaling(found, cfg=AMP):
    """The update_loss_scaling rule over a run's found flags, in numpy,
    from the config's initial scale: [(scale, good, bad) after each
    step]."""
    scale, good, bad = cfg["init_loss_scaling"], 0, 0
    out = []
    for f in found:
        if f:
            good, bad = 0, bad + 1
            if bad >= cfg["decr_every_n_nan_or_inf"]:
                scale, bad = scale * cfg["decr_ratio"], 0
        else:
            good, bad = good + 1, 0
            if good >= cfg["incr_every_n_steps"]:
                scale, good = scale * cfg["incr_ratio"], 0
        scale = max(float(np.float32(scale)), 1.0)
        out.append((scale, good, bad))
    return out
