"""MNIST ConvNet (recognize_digits: conv_pool x2 + fc softmax) on the
port's fluid, a copy of paddle_tpu/models/mnist.py (BASELINE.json
configs[0])."""

from __future__ import annotations

from .. import fluid


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act="relu"):
    conv = fluid.layers.conv2d(input, num_filters=num_filters,
                               filter_size=filter_size, act=act)
    return fluid.layers.pool2d(conv, pool_size=pool_size,
                               pool_stride=pool_stride)


def convnet(img, label):
    """Returns (avg_loss, accuracy, prediction)."""
    c1 = simple_img_conv_pool(img, num_filters=20, filter_size=5,
                              pool_size=2, pool_stride=2)
    c1 = fluid.layers.batch_norm(c1)
    c2 = simple_img_conv_pool(c1, num_filters=50, filter_size=5,
                              pool_size=2, pool_stride=2)
    prediction = fluid.layers.fc(c2, size=10, act="softmax")
    loss = fluid.layers.loss.cross_entropy(prediction, label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(prediction, label)
    return avg_loss, acc, prediction


def build_train_program(optimizer=None, batch_size=-1):
    """Build (main, startup, feeds, fetches) for the train step."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", [batch_size, 1, 28, 28], "float32")
        label = fluid.data("label", [batch_size, 1], "int64")
        avg_loss, acc, pred = convnet(img, label)
        opt = optimizer or fluid.optimizer.Adam(learning_rate=0.001)
        opt.minimize(avg_loss)
    return main, startup, ["img", "label"], [avg_loss, acc]
