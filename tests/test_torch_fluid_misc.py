"""The misc bucket's layers and host rules in programs, against paddle_tpu
on the CPU: `fluid.layers.py_func` calling a host function between two
device ops, `fluid.layers.auc` accumulating its histograms over several
batches (and against `fluid.metrics.Auc`), the io rules' files written by
one package and read by the other (save / load, save_combine /
load_combine), the 1.x metric classes of `fluid.metrics`, and the compat
wrappers of the misc and random buckets building the reference's Program
JSON.

Tolerances.  F32 (rtol 1e-5, atol 1e-6): a few float32 ops whose only
difference is the order of sums; files and counts exactly.
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as JF
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.fluid import unique_name as TU

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _exe(fluid):
    return fluid.Executor() if fluid is JF else fluid.Executor(
        fluid.CPUPlace())


def _py_func_program(fluid, unique_name, calls, idx_dtype="int32"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        x = fluid.data("x", [4, 3], "float32")
        h = fluid.layers.scale(x, 2.0)
        out = main.global_block().create_var(name="host_out", shape=[4, 3],
                                             dtype="float32")
        idx = main.global_block().create_var(name="host_idx", shape=[4],
                                             dtype=idx_dtype)

        def host(a):
            calls.append(type(a))
            return [np.tanh(a) + 1.0, np.argmax(a, axis=1)]

        fluid.layers.py_func(host, h, [out, idx])
        y = fluid.layers.reduce_sum(out, dim=1)
    return main, startup, [y.name, "host_idx"]


def test_py_func_runs_its_host_function_in_both_executors():
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    got = {}
    for fluid, unique_name in ((JF, JU), (TF, TU)):
        calls = []
        main, startup, fetch = _py_func_program(fluid, unique_name, calls)
        exe = _exe(fluid)
        exe.run(startup)
        got[fluid] = [np.asarray(v) for v in
                      exe.run(main, feed={"x": x}, fetch_list=fetch)]
        assert calls
    # the port hands the function numpy copies
    assert all(c is np.ndarray for c in calls)
    np.testing.assert_allclose(got[TF][0], np.sum(np.tanh(2 * x) + 1, 1),
                               **F32)
    np.testing.assert_allclose(got[TF][0], got[JF][0], **F32)
    np.testing.assert_array_equal(got[TF][1], np.argmax(x, 1))
    np.testing.assert_array_equal(got[TF][1], got[JF][1])


def test_a_64_bit_host_output_raises_in_the_reference_only():
    """The reference's pure_callback cannot return int64 with 64-bit
    types off (ROADMAP queue 3); the port gives it."""
    x = np.ones((4, 3), np.float32)
    for fluid, unique_name in ((JF, JU), (TF, TU)):
        main, startup, fetch = _py_func_program(fluid, unique_name, [],
                                                "int64")
        exe = _exe(fluid)
        exe.run(startup)
        if fluid is JF:
            with pytest.raises(ValueError, match="64-bit"):
                exe.run(main, feed={"x": x}, fetch_list=fetch)
        else:
            got = exe.run(main, feed={"x": x}, fetch_list=fetch)
            assert got[1].dtype == np.int64


def _auc_program(fluid, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        p = fluid.data("p", [16, 2], "float32")
        lab = fluid.data("lab", [16, 1], "int64")
        auc, _, (pos, neg) = fluid.layers.auc(p, lab, num_thresholds=63)
    return main, startup, [auc.name, pos.name, neg.name]


def test_auc_accumulates_over_batches_as_the_reference():
    """Four batches: the running AUC and the persistable histograms after
    each, in both Executors, and the last AUC against the host-side
    `fluid.metrics.Auc` over the same scores."""
    jm, js, fetch = _auc_program(JF, JU)
    tm, ts, _ = _auc_program(TF, TU)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    jexe, jscope = JF.Executor(), JF.Scope()
    texe, tscope = TF.Executor(TF.CPUPlace()), TF.Scope()
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    rng = np.random.RandomState(1)
    metric = TF.metrics.Auc("auc", num_thresholds=63)
    for i in range(4):
        lab = rng.randint(0, 2, (16, 1)).astype(np.int64)
        s = np.clip(0.3 * lab[:, 0] + rng.rand(16) * 0.7, 0, 1)
        p = np.stack([1 - s, s], 1).astype(np.float32)
        feed = {"p": p, "lab": lab}
        want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), **F32)
        for w, g in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(g, np.asarray(w))
        metric.update(p, lab)
    assert float(np.asarray(tscope.get(fetch[1])).sum()) > 0
    np.testing.assert_allclose(float(got[0]), metric.eval(), rtol=1e-5)


def _save_program(fluid, unique_name, path, combine):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        a = fluid.layers.create_global_var([2, 3], 1.5, "float32",
                                           persistable=True, name="a")
        b = fluid.layers.create_global_var([4], 7, "int32",
                                           persistable=True, name="b")
        blk = main.global_block()
        if combine:
            blk.append_op("save_combine", inputs={"X": [a, b]},
                          attrs={"file_path": path})
        else:
            blk.append_op("save", inputs={"X": [a]},
                          attrs={"file_path": path})
    return main, startup


def _load_program(fluid, unique_name, path, combine):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        blk = main.global_block()
        a = blk.create_var(name="la", shape=[2, 3], dtype="float32")
        b = blk.create_var(name="lb", shape=[4], dtype="int32")
        if combine:
            blk.append_op("load_combine", outputs={"Out": [a, b]},
                          attrs={"file_path": path})
        else:
            blk.append_op("load", outputs={"Out": [a]},
                          attrs={"file_path": path})
    return main, (["la", "lb"] if combine else ["la"])


@pytest.mark.parametrize("combine", [True, False],
                         ids=["save_combine", "save"])
@pytest.mark.parametrize("writer,reader", [(JF, TF), (TF, JF), (TF, TF)],
                         ids=["reference_to_port", "port_to_reference",
                              "port_to_port"])
def test_a_file_written_by_one_package_loads_in_the_other(
        tmp_path, writer, reader, combine):
    uniq = {JF: JU, TF: TU}
    path = str(tmp_path / "state")
    main, startup = _save_program(writer, uniq[writer], path, combine)
    exe = _exe(writer)
    scope = writer.Scope()
    exe.run(startup, scope=scope)
    va = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    vb = np.array([3, -1, 4, 1], np.int32)
    if writer is TF:
        load_jax_scope(scope, {"a": va, "b": vb})
    else:
        scope.set("a", va)
        scope.set("b", vb)
    exe.run(main, scope=scope)
    lmain, fetch = _load_program(reader, uniq[reader], path, combine)
    got = _exe(reader).run(lmain, fetch_list=fetch, scope=reader.Scope())
    np.testing.assert_array_equal(np.asarray(got[0]), va)
    if combine:
        np.testing.assert_array_equal(np.asarray(got[1]), vb)


def test_metrics_classes_answer_as_the_reference():
    """The 1.x metric classes are copies: the same updates give the same
    answers."""
    rng = np.random.RandomState(2)
    preds = rng.rand(20, 1)
    labels = rng.randint(0, 2, (20, 1))
    out = {}
    for fluid in (JF, TF):
        m = fluid.metrics
        p, r = m.Precision(), m.Recall()
        acc = m.Accuracy()
        auc = m.Auc("auc", num_thresholds=31)
        ed = m.EditDistance("ed")
        comp = m.CompositeMetric()
        comp.add_metric(m.Precision())
        comp.add_metric(m.Recall())
        for i in range(0, 20, 5):
            p.update(preds[i:i + 5], labels[i:i + 5])
            r.update(preds[i:i + 5], labels[i:i + 5])
            acc.update(float(preds[i:i + 5].mean()), 5)
            auc.update(np.concatenate([1 - preds[i:i + 5],
                                       preds[i:i + 5]], 1),
                       labels[i:i + 5])
            ed.update(np.array([[1.0], [0.0], [2.0]]), 3)
            comp.update(preds[i:i + 5], labels[i:i + 5])
        out[fluid] = [p.eval(), r.eval(), acc.eval(), auc.eval(),
                      *ed.eval(), *comp.eval()]
    np.testing.assert_allclose(out[TF], out[JF], rtol=1e-12)


def test_misc_and_random_compat_wrappers_build_the_reference_program():
    """The eleven compat wrappers of the misc and random buckets give the
    reference's JSON; the deterministic ones compute its values."""
    def build(fluid, unique_name):
        main, startup = fluid.Program(), fluid.Program()
        L = fluid.layers
        with fluid.program_guard(main, startup), unique_name.guard():
            x = fluid.data("x", [2, 4, 6], "float32")
            img = fluid.data("img", [2, 6, 2, 2], "float32")
            ids = fluid.data("ids", [5, 1], "int64")
            pr = fluid.data("pr", [2, 3], "float32")
            lab = fluid.data("lab", [6, 1], "float32")
            cvm = fluid.data("cvm", [2, 2], "float32")
            det = [L.add_position_encoding(x, alpha=0.5, beta=2.0),
                   L.continuous_value_model(L.reshape(x, [2, 24]), cvm),
                   L.shard_index(ids, index_num=12, nshards=3, shard_id=1),
                   L.shuffle_channel(img, group=2),
                   L.teacher_student_sigmoid_loss(L.reshape(pr, [6, 1]),
                                                  lab),
                   L.is_empty(x),
                   L.mean_iou(ids, ids, num_classes=12)[0]]
            drawn = [L.sampling_id(pr), L.random_crop(x, [2, 3]),
                     L.gaussian_random_batch_size_like(x, shape=[-1, 3]),
                     L.uniform_random_batch_size_like(x, shape=[-1, 3])]
        return main, startup, det, drawn

    jm, js, jdet, jdrawn = build(JF, JU)
    tm, ts, tdet, tdrawn = build(TF, TU)
    assert _json(tm) == _json(jm)
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(2, 4, 6).astype(np.float32),
            "img": rng.randn(2, 6, 2, 2).astype(np.float32),
            "ids": rng.randint(0, 12, (5, 1)).astype(np.int64),
            "pr": np.full((2, 3), 1 / 3, np.float32),
            "lab": np.array([[0.4], [-0.5], [-2.0], [1.5], [0.0], [1.0]],
                            np.float32),
            "cvm": np.abs(rng.randn(2, 2)).astype(np.float32)}
    feed["x"] = np.abs(feed["x"])
    want = JF.Executor().run(jm, feed=feed, fetch_list=jdet + jdrawn)
    got = TF.Executor(TF.CPUPlace()).run(TF.Program.from_dict(jm.to_dict()),
                                         feed=feed,
                                         fetch_list=[v.name for v in
                                                     jdet + jdrawn])
    for w, g in zip(want[:len(jdet)], got[:len(jdet)]):
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **F32)
        else:
            np.testing.assert_array_equal(g, w)
    for w, g in zip(want[len(jdet):], got[len(jdet):]):
        assert np.asarray(g).shape == np.asarray(w).shape


@pytest.mark.parametrize("fluid,unique_name", [(JF, JU), (TF, TU)],
                         ids=["reference", "port"])
def test_a_save_combine_of_one_var_does_not_load_combine(tmp_path, fluid,
                                                         unique_name):
    """The reference's save_combine of one tensor writes the plain
    pickle, and load_combine reads only the npz bundle (ROADMAP queue
    3): followed, in both packages."""
    path = str(tmp_path / "one")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        a = fluid.layers.create_global_var([2], 1.0, "float32",
                                           persistable=True, name="a")
        main.global_block().append_op("save_combine", inputs={"X": [a]},
                                      attrs={"file_path": path})
    exe, scope = _exe(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, scope=scope)
    lmain = fluid.Program()
    with fluid.program_guard(lmain, fluid.Program()), unique_name.guard():
        la = lmain.global_block().create_var(name="la", shape=[2],
                                             dtype="float32")
        lmain.global_block().append_op("load_combine",
                                       outputs={"Out": [la]},
                                       attrs={"file_path": path})
    with pytest.raises(Exception, match="No such file|npz"):
        exe.run(lmain, fetch_list=["la"], scope=fluid.Scope())
