"""ResNet (v1.5) static-graph model on the port's fluid (a copy of
paddle_tpu/models/resnet.py, BASELINE.json configs[1], ResNet-50): conv +
batch-norm stacks built from fluid.layers, trained with Momentum and
L2Decay.  The same builder under `unique_name.guard()` gives the same
Program JSON as the reference's.  `piecewise_decay` learning rates are not
ported.
"""

from __future__ import annotations

from .. import fluid

# depth -> (block fn name, stage repeats)
_CONFIGS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, act=None,
                  is_test=False):
    conv = fluid.layers.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, bias_attr=False)
    return fluid.layers.batch_norm(conv, act=act, is_test=is_test)


def _shortcut(input, ch_out, stride, is_test):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def basic_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, act="relu",
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1, is_test=is_test)
    short = _shortcut(input, num_filters, stride, is_test)
    return fluid.layers.relu(fluid.layers.elementwise_add(short, conv1))


def bottleneck_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", is_test=is_test)
    # v1.5: the 3x3 conv carries the stride (not the 1x1), better accuracy.
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu",
                          is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, is_test=is_test)
    short = _shortcut(input, num_filters * 4, stride, is_test)
    return fluid.layers.relu(fluid.layers.elementwise_add(short, conv2))


def resnet(input, class_num=1000, depth=50, width=64, is_test=False):
    """Returns softmax prediction [N, class_num]."""
    block_fn_name, repeats = _CONFIGS[depth]
    block_fn = basic_block if block_fn_name == "basic" else bottleneck_block

    conv = conv_bn_layer(input, width, 7, stride=2, act="relu",
                         is_test=is_test)
    conv = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max")
    for stage, n in enumerate(repeats):
        filters = width * (2 ** stage)
        for i in range(n):
            conv = block_fn(conv, filters, stride=2 if i == 0 and stage > 0
                            else 1, is_test=is_test)
    pool = fluid.layers.adaptive_pool2d(conv, pool_size=1, pool_type="avg")
    return fluid.layers.fc(pool, size=class_num, act="softmax")


def build_train_program(depth=50, class_num=1000, image_shape=(3, 224, 224),
                        batch_size=-1, width=64, optimizer=None,
                        lr_boundaries=None, lr_values=None):
    """Build (main, startup, feed_names, fetches) for one train step."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", [batch_size] + list(image_shape), "float32")
        label = fluid.data("label", [batch_size, 1], "int64")
        pred = resnet(img, class_num=class_num, depth=depth, width=width)
        loss = fluid.layers.loss.cross_entropy(pred, label)
        avg_loss = fluid.layers.mean(loss)
        acc = fluid.layers.accuracy(pred, label)
        if optimizer is None:
            if lr_boundaries:
                raise NotImplementedError("piecewise_decay is not ported")
            optimizer = fluid.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9,
                regularization=fluid.regularizer.L2Decay(1e-4))
        optimizer.minimize(avg_loss)
    return main, startup, ["image", "label"], [avg_loss, acc]
