"""The port's Fluid front end builds the reference's programs: the ResNet
(depth 18 and 50 at toy width, 32 x 32) and MNIST builders of
paddle_tpu_torch/models and the port's twins of the fixture programs of
tests/fixtures/programs.py give the same `Program.to_dict()` as
paddle_tpu's, under `unique_name.guard()`, main and startup alike.  That
equality covers every var's inferred shape and dtype (the -1 batch
included: the port infers them by running its rules on meta tensors, the
reference by `jax.eval_shape`), every op's inputs, outputs and attrs, and
the op-version map; the static mode of examples/quickstart_mnist.py is
built the same way in both.  JSON from either package loads in the other and
serializes back unchanged.  The comparison is exact: a Program is plain
data.
"""

import json

import pytest

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import framework as JFW
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.models import mnist as JMN
from paddle_tpu.models import resnet as JR
from fixtures import programs as ref_fixtures

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import framework, unique_name
from paddle_tpu_torch.models import mnist as TMN
from paddle_tpu_torch.models import resnet as TR


# -- the port's twins of tests/fixtures/programs.py --------------------------

def _build(body):
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        with unique_name.guard():
            fetch = body()
    return main, startup, fetch


def linear_sgd():
    def body():
        x = fluid.data("x", [-1, 4], "float32")
        yt = fluid.data("yt", [-1, 1], "float32")
        pred = fluid.layers.fc(x, 1)
        loss = fluid.layers.reduce_mean(
            fluid.layers.loss.square_error_cost(pred, yt))
        fluid.optimizer.SGD(0.01).minimize(loss)
        return [loss]

    return _build(body)


def mlp_adam():
    def body():
        x = fluid.data("x", [-1, 8], "float32")
        yt = fluid.data("yt", [-1, 1], "float32")
        h = fluid.layers.fc(x, 16, act="relu")
        h = fluid.layers.fc(h, 16, act="tanh")
        pred = fluid.layers.fc(h, 1, bias_attr=False)
        loss = fluid.layers.reduce_mean(
            fluid.layers.loss.square_error_cost(pred, yt))
        fluid.optimizer.Adam(1e-3).minimize(loss)
        return [loss]

    return _build(body)


def shared_embedding_ngram():
    def body():
        words = [fluid.data(n, [-1, 1], "int64") for n in ("w0", "w1", "w2")]
        nxt = fluid.data("nxt", [-1, 1], "int64")
        embeds = [fluid.layers.embedding(
            fluid.layers.reshape(w, [-1]), size=[32, 8],
            param_attr="shared_emb") for w in words]
        concat = fluid.layers.concat(embeds, axis=1)
        hidden = fluid.layers.fc(concat, 16, act="sigmoid")
        logits = fluid.layers.fc(hidden, 32)
        loss = fluid.layers.reduce_mean(
            fluid.layers.softmax_with_cross_entropy(
                logits, fluid.layers.reshape(nxt, [-1, 1])))
        fluid.optimizer.SGD(0.1).minimize(loss)
        return [loss]

    return _build(body)


def batchnorm_train():
    def body():
        x = fluid.data("x", [-1, 6], "float32")
        yt = fluid.data("yt", [-1, 1], "float32")
        h = fluid.layers.fc(x, 8)
        h = fluid.layers.batch_norm(h)
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.reduce_mean(
            fluid.layers.loss.square_error_cost(pred, yt))
        fluid.optimizer.SGD(0.01).minimize(loss)
        return [loss]

    return _build(body)


def batchnorm_for_test():
    main, startup, fetch = batchnorm_train()
    return main.clone(for_test=True), startup, fetch


def quickstart(fl):
    """The static mode of examples/quickstart_mnist.py, over either
    package's fluid (`fl`)."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.data("x", [-1, 1, 28, 28], "float32")
        y = fl.data("y", [-1, 1], "int64")
        h = fl.layers.conv2d(x, 6, 5, act="relu")
        h = fl.layers.pool2d(h, 2, pool_stride=2)
        h = fl.layers.conv2d(h, 16, 5, act="relu")
        h = fl.layers.pool2d(h, 2, pool_stride=2)
        h = fl.layers.fc(h, 120, act="relu")
        h = fl.layers.fc(h, 84, act="relu")
        logits = fl.layers.fc(h, 10)
        loss = fl.layers.reduce_mean(
            fl.layers.softmax_with_cross_entropy(logits, y))
        fl.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, [loss]


PORT_FIXTURES = {
    "linear_sgd": linear_sgd,
    "mlp_adam": mlp_adam,
    "shared_embedding_ngram": shared_embedding_ngram,
    "batchnorm_train": batchnorm_train,
    "batchnorm_for_test": batchnorm_for_test,
}

# (reference builder, port builder) -> (main, startup, fetch list)
MODELS = {
    "resnet18": dict(depth=18, class_num=10, image_shape=(3, 32, 32),
                     width=8),
    "resnet50": dict(depth=50, class_num=10, image_shape=(3, 32, 32),
                     width=4),
    "resnet18_b8": dict(depth=18, class_num=10, image_shape=(3, 32, 32),
                        width=8, batch_size=8),
}


def builders(name):
    """(reference builder, port builder) for a model or fixture name,
    each returning (main, startup, fetch_list)."""
    if name in PORT_FIXTURES:
        return ref_fixtures.FIXTURES[name], PORT_FIXTURES[name]
    if name == "quickstart":
        def ref():
            with JU.guard():
                return quickstart(JF)

        def port():
            with unique_name.guard():
                return quickstart(fluid)

        return ref, port

    def ref():
        with JU.guard():
            if name == "mnist":
                m, s, _, f = JMN.build_train_program()
            else:
                m, s, _, f = JR.build_train_program(**MODELS[name])
        return m, s, f

    def port():
        with unique_name.guard():
            if name == "mnist":
                m, s, _, f = TMN.build_train_program()
            else:
                m, s, _, f = TR.build_train_program(**MODELS[name])
        return m, s, f

    return ref, port


NAMES = sorted(MODELS) + ["mnist", "quickstart"] + sorted(PORT_FIXTURES)


def _json(program):
    """to_dict through JSON text: tuples become lists, as on disk."""
    return json.loads(json.dumps(program.to_dict()))


@pytest.mark.parametrize("name", NAMES)
def test_builders_give_the_reference_program(name):
    ref, port = builders(name)
    (jm, js, jf), (tm, ts, tf) = ref(), port()
    assert _json(tm) == _json(jm)
    assert _json(ts) == _json(js)
    assert [v.name for v in tf] == [v.name for v in jf]


@pytest.mark.parametrize("name", NAMES)
def test_json_round_trips_both_ways(name):
    ref, port = builders(name)
    jm, tm = ref()[0], port()[0]
    want = _json(jm)
    assert _json(framework.Program.from_dict(want)) == want
    assert _json(JFW.Program.from_dict(_json(tm))) == want


def test_inferred_shapes_keep_the_dynamic_batch():
    """The default batch is -1: the port's meta-tensor inference marks
    the dims that follow it as -1, where the reference does."""
    _, port = builders("resnet50")
    ref, _ = builders("resnet50")
    tb, jb = port()[0].global_block(), ref()[0].global_block()
    dynamic = [n for n, v in jb.vars.items() if v.shape and v.shape[0] == -1]
    assert len(dynamic) > 100
    for n in dynamic:
        assert tb.var(n).shape == jb.var(n).shape, n
        assert tb.var(n).dtype == jb.var(n).dtype, n
    pred = [op for op in tb.ops if op.type == "softmax"][0]
    assert tb.var(pred.output("Out")[0]).shape == (-1, 10)


def test_conv_count_and_optimizer_ops_of_resnet50():
    """49 block convs + 4 projection shortcuts, one momentum op and one
    L2Decay scale + sum pair for each of the 161 trainable parameters."""
    main = builders("resnet50")[1]()[0]
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("conv2d") == 53
    n_params = len([p for p in main.all_parameters() if p.trainable])
    assert n_params == 161
    assert ops.count("momentum") == n_params


def test_clone_for_test_prunes_backward_and_sets_is_test():
    main = PORT_FIXTURES["batchnorm_for_test"]()[0]
    ops = main.global_block().ops
    assert not any(op.attr("op_role", 0) & (fluid.OpRole.Backward
                                            | fluid.OpRole.Optimize)
                   for op in ops)
    bn = [op for op in ops if op.type == "batch_norm"]
    assert bn and all(op.attr("is_test") for op in bn)


def test_an_op_that_cannot_run_on_meta_keeps_its_declared_shapes():
    """A reshape2 whose target shape is a tensor input needs its values:
    both packages bail out of inference and keep the declared shape; the
    port books `shape_infer_bailouts`."""
    from paddle_tpu_torch import profiler

    shapes = []
    for fl in (JF, fluid):
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            x = fl.data("x", [-1, 6], "float32")
            shp = fl.data("shp", [2], "int32")
            blk = main.global_block()
            out = blk.create_var(name="out", shape=[7, 7], dtype="float32")
            xs = blk.create_var(name="xs", shape=[0], dtype="float32")
            before = profiler.get_int_stats().get("shape_infer_bailouts", 0)
            blk.append_op("reshape2", inputs={"X": [x], "Shape": [shp]},
                          outputs={"Out": [out], "XShape": [xs]},
                          attrs={"shape": [0, 0]})
            shapes.append(out.shape)
    assert shapes == [(7, 7), (7, 7)]
    assert profiler.get_int_stats()["shape_infer_bailouts"] == before + 1


def test_an_op_with_no_rule_keeps_its_declared_shapes():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data("x", [-1, 6], "float32")
        out = main.global_block().create_var(name="o", shape=[3],
                                             dtype="float32")
        main.global_block().append_op("not_a_rule", inputs={"X": [x]},
                                      outputs={"Out": [out]})
    assert out.shape == (3,)
