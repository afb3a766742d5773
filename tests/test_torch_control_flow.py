"""The static control flow of the port against paddle_tpu on the CPU: the
reference's TensorArray programs (tests/test_ops_rnn.py:205-250),
`while_loop`, `cond`, `case` and `switch_case` (held against numpy:
the reference's own case/switch_case test fails in tier-1 runs,
ROADMAP queue 3), a hand-written `conditional_block`, and the JSON of
each program run by the other package's Executor.  Every program is
built by both packages (the same JSON) and run through both Executors.

Then what only the port's design shows: a `while` op whose X lists
neither the parameter its body reads nor the encoder-like value read on
every iteration (the Executor walks the sub-block), the host reads a
loop costs, fresh random bits each iteration, the capacity contract of
a write inside a loop, and `tensor_array_to_tensor` after a loop that
ends before its capacity (the port gives the elements written; the
reference's single jit gives the whole capacity: ROADMAP queue 3).

Tolerances: F32 (rtol 1e-5, atol 1e-6), a few float32 operations whose
only difference is the order of summation; integer results exactly.
"""

import json

import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu.fluid as JF
from paddle_tpu.fluid import dygraph as Jdy
from paddle_tpu.fluid import flags as jax_flags
from paddle_tpu.fluid import unique_name as JU

import paddle_tpu_torch as T
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import load_jax_scope
from paddle_tpu_torch.fluid import unique_name as TU

F32 = dict(rtol=1e-5, atol=1e-6)

# the rules these programs hold (test_torch_fluid_ops.py's coverage test
# counts them): the tensor-array rules and the two sub-block rules
PROGRAM_RULES = {"while", "conditional_block", "allocate_array",
                 "write_to_array", "read_from_array", "lod_array_length",
                 "tensor_array_to_tensor"}


@pytest.fixture(scope="module", autouse=True)
def _no_shared_aot_cache():
    old = jax_flags.get_flags("FLAGS_aot_cache")
    jax_flags.set_flags({"FLAGS_aot_cache": "off"})
    try:
        yield
    finally:
        jax_flags.set_flags({"FLAGS_aot_cache": old})


def _build(fluid, unique_name, builder):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), unique_name.guard():
        fetches = builder(fluid)
    return main, startup, fetches


def _json(prog):
    return json.dumps(prog.to_dict(), sort_keys=True, default=str)


def _run_ref(main_dict, startup_dict, feed, names):
    exe, scope = JF.Executor(), JF.Scope()
    exe.run(JF.Program.from_dict(startup_dict), scope=scope)
    out = exe.run(JF.Program.from_dict(main_dict), feed=feed,
                  fetch_list=names, scope=scope)
    return [np.asarray(o) for o in out], scope


def _run_port(main_dict, startup_dict, feed, names, state=None):
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    exe.run(TF.Program.from_dict(startup_dict), scope=scope)
    if state is not None:
        load_jax_scope(scope, state)
    out = exe.run(TF.Program.from_dict(main_dict), feed=feed,
                  fetch_list=names, scope=scope)
    return [np.asarray(o) for o in out]


def _both(builder, feed):
    """The program built by both packages (the same JSON); (reference,
    port) fetches, the port run from the reference's startup state.  The
    JSON each package wrote runs in the other package's Executor too:
    the port's through the reference's, the reference's through the
    port's (which is what the port's fetches come from)."""
    jm, js, jf = _build(JF, JU, builder)
    tm, ts, tf = _build(TF, TU, builder)
    assert _json(tm) == _json(jm) and _json(ts) == _json(js)
    names = [v.name for v in jf]
    want, jscope = _run_ref(jm.to_dict(), js.to_dict(), feed, names)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    got = _run_port(jm.to_dict(), js.to_dict(), feed, names, state)
    again, _ = _run_ref(tm.to_dict(), ts.to_dict(), feed, names)
    for w, a in zip(want, again):
        np.testing.assert_array_equal(a, w)
    return want, got


def _same(want, got):
    for w, g in zip(want, got):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, **F32)
        else:
            np.testing.assert_array_equal(g, w)


# -- the reference's TensorArray programs -----------------------------------------

def _write_read_outside_loop(fluid):
    L = fluid.layers
    x = fluid.data("x", [2, 3], "float32")
    i0 = L.fill_constant([1], "int64", 0)
    i1 = L.fill_constant([1], "int64", 1)
    arr = L.array_write(x, i0)
    arr = L.array_write(x * 2.0, i1, array=arr)
    return [L.array_read(arr, i1), L.array_length(arr)]


def _array_in_while_loop(fluid, n_steps=5, capacity=5):
    L = fluid.layers
    x = fluid.data("x", [2], "float32")
    arr = L.create_array("float32", capacity=capacity, element_shape=[2])
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", n_steps)
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        val = x * L.cast(i, "float32")
        L.array_write(val, i, array=arr)
        L.increment_(i, 1)
        L.assign(L.less_than(i, limit), cond)
    out3 = L.array_read(arr, L.fill_constant([1], "int64", 3))
    return [out3, L.array_length(arr), i]


def test_tensor_array_write_read_outside_loop():
    x = np.arange(6, dtype="float32").reshape(2, 3)
    want, got = _both(_write_read_outside_loop, {"x": x})
    _same(want, got)
    np.testing.assert_allclose(got[0], x * 2.0)
    assert got[1].item() == 2


def test_tensor_array_in_while_loop():
    x = np.array([1.0, 2.0], "float32")
    want, got = _both(_array_in_while_loop, {"x": x})
    _same(want, got)
    np.testing.assert_allclose(got[0], x * 3.0)
    assert got[1].item() == 5 and got[2].item() == 5


def _array_to_tensor(fluid, arr, dtype, **attrs):
    helper = fluid.layer_helper.LayerHelper("tensor_array_to_tensor")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    idx = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("tensor_array_to_tensor", inputs={"X": [arr]},
                     outputs={"Out": [out], "OutIndex": [idx]},
                     attrs=dict({"axis": 0, "use_stack": False}, **attrs))
    return out, idx


@pytest.mark.parametrize("attrs", [{"use_stack": True},
                                   {"axis": 0, "use_stack": False},
                                   {"axis": 1, "use_stack": False}])
def test_tensor_array_to_tensor_of_a_full_array(attrs):
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [2, 3], "float32")
        arr = L.create_array("float32", capacity=4, element_shape=[2, 3])
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 4)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.array_write(x + L.cast(i, "float32"), i, array=arr)
            L.increment_(i, 1)
            L.assign(L.less_than(i, limit), cond)
        return list(_array_to_tensor(fluid, arr, "float32", **attrs))

    x = np.arange(6, dtype="float32").reshape(2, 3)
    want, got = _both(build, {"x": x})
    _same(want, got)
    elems = [x + k for k in range(4)]
    oracle = np.stack(elems) if attrs["use_stack"] else \
        np.concatenate(elems, axis=attrs["axis"])
    np.testing.assert_allclose(got[0], oracle)


def test_tensor_array_to_tensor_after_an_early_exit():
    """3 of a capacity of 5 written: the port gives those 3 (one host
    read of the length); the reference's Executor, whose whole block is
    one jit, cannot slice by a traced length and gives all 5, the last
    2 zero (ROADMAP queue 3)."""
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [2], "float32")
        arr = L.create_array("float32", capacity=5, element_shape=[2])
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.array_write(x * L.cast(i + 1, "float32"), i, array=arr)
            L.increment_(i, 1)
            L.assign(L.less_than(i, limit), cond)
        return [_array_to_tensor(fluid, arr, "float32", use_stack=True)[0]]

    x = np.array([1.0, 2.0], "float32")
    want, got = _both(build, {"x": x})
    np.testing.assert_allclose(got[0], np.stack([x, 2 * x, 3 * x]))
    assert want[0].shape == (5, 2)
    np.testing.assert_allclose(want[0][:3], got[0])
    assert not want[0][3:].any()


def test_a_write_inside_a_loop_needs_a_capacity_in_both():
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [2], "float32")
        arr = L.create_array("float32")
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 2)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.array_write(x, i, array=arr)
            L.increment_(i, 1)
            L.assign(L.less_than(i, limit), cond)
        return [L.array_length(arr)]

    feed = {"x": np.ones(2, "float32")}
    jm, js, jf = _build(JF, JU, build)
    with pytest.raises(Exception, match="preallocated array"):
        _run_ref(jm.to_dict(), js.to_dict(), feed, [jf[0].name])
    tm, ts, tf = _build(TF, TU, build)
    with pytest.raises(ValueError, match="preallocated array"):
        _run_port(tm.to_dict(), ts.to_dict(), feed, [tf[0].name])


# -- while_loop, cond, case, switch_case ----------------------------------------

def _while_loop_program(fluid):
    """Sum of i * x for i < 10, and the count."""
    L = fluid.layers
    x = fluid.data("x", [3], "float32")
    i = L.fill_constant([1], "int64", 0)
    s = L.fill_constant([3], "float32", 0.0)
    ten = L.fill_constant([1], "int64", 10)

    def cond(i, s):
        return L.less_than(i, ten)

    def body(i, s):
        return [L.increment(i, 1, in_place=False),
                L.elementwise_add(s, x * L.cast(i, "float32"))]

    i, s = L.while_loop(cond, body, [i, s])
    return [i, s]


def test_while_loop():
    x = np.array([1.0, -2.0, 0.5], "float32")
    want, got = _both(_while_loop_program, {"x": x})
    _same(want, got)
    assert got[0].item() == 10
    np.testing.assert_allclose(got[1], 45.0 * x, **F32)


def _cond_program(fluid):
    L = fluid.layers
    x = fluid.data("x", [2, 3], "float32")
    a = fluid.data("a", [1], "float32")
    pred = L.less_than(a, L.fill_constant([1], "float32", 0.0))
    one = L.cond(pred, lambda: L.exp(x), lambda: x * 3.0)
    two = L.cond(pred, lambda: [x + 1.0, L.reduce_sum(x)],
                 lambda: [x - 1.0, L.reduce_mean(x)])
    return [one] + list(two)


@pytest.mark.parametrize("a", [-1.0, 2.0])
def test_cond_selects_the_branch(a):
    x = np.random.RandomState(0).randn(2, 3).astype("float32")
    feed = {"x": x, "a": np.array([a], "float32")}
    want, got = _both(_cond_program, feed)
    _same(want, got)
    if a < 0:
        oracle = [np.exp(x), x + 1.0, x.sum()]
    else:
        oracle = [x * 3.0, x - 1.0, x.mean()]
    for g, o in zip(got, oracle):
        np.testing.assert_allclose(g.reshape(np.shape(o)), o, **F32)


def _case_program(fluid, static):
    L = fluid.layers
    x = fluid.data("x", [1], "float32")
    one = lambda: L.fill_constant([1], "float32", 1.0)  # noqa: E731
    two = lambda: L.fill_constant([1], "float32", 2.0)  # noqa: E731
    three = lambda: L.fill_constant([1], "float32", 3.0)  # noqa: E731
    pred_hi = x > L.fill_constant([1], "float32", 10.0)
    pred_lo = x > L.fill_constant([1], "float32", 0.0)
    out = static.nn.case([(pred_hi, one), (pred_lo, two)], default=three)
    no_default = static.nn.case([(pred_hi, one), (pred_lo, two)])
    idx = fluid.data("i", [1], "int64")
    sw = static.nn.switch_case(idx, {0: one, 1: two, 3: three})
    sw_list = static.nn.switch_case(idx, [one, two], default=three)
    return [out, no_default, sw, sw_list]


@pytest.mark.parametrize("x,i", [(5.0, 1), (50.0, 7), (-4.0, 0),
                                 (-4.0, 3)])
def test_case_and_switch_case_against_numpy(x, i):
    """case: the first true predicate's branch, else the default (the
    last pair's when none is given); switch_case: the branch of the
    index, else the default (the largest index's when none is given)."""
    tm, ts, tf = _build(TF, TU, lambda fl: _case_program(fl, T.static))
    jm, js, _ = _build(JF, JU, lambda fl: _case_program(fl, J.static))
    assert _json(tm) == _json(jm)
    feed = {"x": np.array([x], "float32"), "i": np.array([i], "int64")}
    got = _run_port(tm.to_dict(), ts.to_dict(), feed, [v.name for v in tf])
    oracle_case = 1.0 if x > 10 else 2.0 if x > 0 else 3.0
    oracle_nodef = 1.0 if x > 10 else 2.0
    oracle_sw = {0: 1.0, 1: 2.0, 3: 3.0}.get(i, 3.0)
    oracle_list = {0: 1.0, 1: 2.0}.get(i, 3.0)
    assert [float(g[0]) for g in got] == [oracle_case, oracle_nodef,
                                          oracle_sw, oracle_list]


# -- conditional_block, hand-written -----------------------------------------------

def _conditional_block_program(fluid):
    """y = x * 2 and z = x + y inside a conditional_block's sub-block
    when `flag`.  y, set before the op, is among its inputs and keeps
    its value when the block is skipped; z is not, and is zeros then
    (the reference's rule)."""
    L = fluid.layers
    x = fluid.data("x", [2, 3], "float32")
    flag = fluid.data("flag", [1], "bool")
    main = fluid.default_main_program()
    y = L.assign(x)
    z = main.current_block().create_var(name="z", dtype="float32",
                                        shape=[2, 3])
    sub = main._create_block()
    sub.append_op("scale", inputs={"X": [x]}, outputs={"Out": [y]},
                  attrs={"scale": 2.0, "bias": 0.0,
                         "bias_after_scale": True})
    sub.append_op("elementwise_add", inputs={"X": [x], "Y": [y]},
                  outputs={"Out": [z]}, attrs={"axis": -1})
    main._rollback()
    main.current_block().append_op(
        "conditional_block", inputs={"Cond": [flag], "Input": [x, y]},
        outputs={"Out": [y, z], "Scope": ["@EMPTY@"]},
        attrs={"sub_block": sub.idx, "is_scalar_condition": True},
        infer_shape=False)
    return [y, z]


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block(flag):
    x = np.random.RandomState(1).randn(2, 3).astype("float32")
    feed = {"x": x, "flag": np.array([flag])}
    want, got = _both(_conditional_block_program, feed)
    _same(want, got)
    if flag:
        np.testing.assert_allclose(got[0], 2 * x, **F32)
        np.testing.assert_allclose(got[1], 3 * x, **F32)
    else:
        np.testing.assert_array_equal(got[0], x)
        np.testing.assert_array_equal(got[1], np.zeros((2, 3), "float32"))


def _conditional_block_grad_program(fluid, inplace):
    """h = x W into a conditional_block (y = 2h, z = h + y when `flag`),
    and W's gradient of mean(y) + mean(z) through it.  `inplace`: y is
    set to h before the op and listed among its inputs, so a skipped
    block passes it through; else y is the block's own, zeros when
    skipped."""
    L = fluid.layers
    x = fluid.data("x", [2, 3], "float32")
    flag = fluid.data("flag", [1], "bool")
    w = L.create_parameter([3, 3], "float32", name="w_cond")
    main = fluid.default_main_program()
    block = main.current_block()
    h = L.mul(x, w)
    y = L.assign(h) if inplace else block.create_var(
        name="y", dtype="float32", shape=[2, 3])
    z = block.create_var(name="z", dtype="float32", shape=[2, 3])
    sub = main._create_block()
    sub.append_op("scale", inputs={"X": [h]}, outputs={"Out": [y]},
                  attrs={"scale": 2.0, "bias": 0.0,
                         "bias_after_scale": True})
    sub.append_op("elementwise_add", inputs={"X": [h], "Y": [y]},
                  outputs={"Out": [z]}, attrs={"axis": -1})
    main._rollback()
    block.append_op(
        "conditional_block",
        inputs={"Cond": [flag], "Input": [h, y] if inplace else [h]},
        outputs={"Out": [y, z], "Scope": ["@EMPTY@"]},
        attrs={"sub_block": sub.idx, "is_scalar_condition": True},
        infer_shape=False)
    loss = L.elementwise_add(L.reduce_mean(y), L.reduce_mean(z))
    fluid.backward.append_backward(loss)
    return [loss, main.global_block().var("w_cond@GRAD")]


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("flag", [True, False])
def test_gradient_through_a_conditional_block(flag, inplace):
    """W's gradient through the block equals the reference's (`lax.cond`
    differentiated), and for the block's own outputs the true one: 5/6
    of x's column sums when it runs, nothing when skipped.  An output
    the block also reads (`inplace`) has its cotangent counted twice by
    both packages' append_backward (ROADMAP queue 3 item 20): parity
    only."""
    x = np.random.RandomState(4).randn(2, 3).astype("float32")
    feed = {"x": x, "flag": np.array([flag])}
    want, got = _both(lambda fl: _conditional_block_grad_program(
        fl, inplace), feed)
    _same(want, got)
    if not inplace:
        col = np.repeat(x.sum(0)[:, None], 3, axis=1)
        np.testing.assert_allclose(got[1], col * (5 / 6 if flag else 0),
                                   **F32)


def test_no_gradient_through_a_while_loop():
    """append_backward over a While gives a while_grad op, and running it
    raises in both packages (the reference: reverse mode through
    lax.while_loop); the port never trains the loop's parameters on
    zeros."""
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [2, 3], "float32")
        w = L.create_parameter([3, 3], "float32", name="w_while")
        acc = L.mul(x, w)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.assign(L.mul(acc, w), acc)
            L.increment_(i, 1)
            L.assign(L.less_than(i, limit), cond)
        fluid.backward.append_backward(L.reduce_mean(acc))
        return [acc]

    feed = {"x": np.ones((2, 3), "float32")}
    for fluid, un in ((JF, JU), (TF, TU)):
        main, startup, _ = _build(fluid, un, build)
        assert "while_grad" in [o.type for o in main.global_block().ops]
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        err = NotImplementedError if fluid is TF else ValueError
        with pytest.raises(err, match="while"):
            exe.run(main, feed=feed, fetch_list=["w_while@GRAD"],
                    scope=scope)


# -- what the port's design adds --------------------------------------------------

def _hidden_reads_program(fluid):
    """A loop whose body reads a parameter and a value computed before
    the loop (h = x W, read on every iteration, never after)."""
    L = fluid.layers
    x = fluid.data("x", [2, 3], "float32")
    w = L.create_parameter([3, 3], "float32", name="w_loop")
    h = L.mul(x, w)
    acc = L.fill_constant([2, 3], "float32", 0.0)
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", 4)
    cond = L.less_than(i, limit)
    with L.While(cond).block():
        L.assign(L.elementwise_add(acc, L.elementwise_add(h, L.mul(x, w))),
                 acc)
        L.increment_(i, 1)
        L.assign(L.less_than(i, limit), cond)
    return [acc]


def test_a_while_op_that_lists_no_outer_reads():
    """The program's JSON with the while op's X emptied (a hand-written
    op): the port's Executor still finds the parameter as state and
    keeps h alive through every iteration."""
    tm, ts, tf = _build(TF, TU, _hidden_reads_program)
    d = tm.to_dict()
    (op,) = [o for o in d["blocks"][0]["ops"] if o["type"] == "while"]
    op["inputs"]["X"] = []
    x = np.random.RandomState(2).randn(2, 3).astype("float32")
    w = np.random.RandomState(3).randn(3, 3).astype("float32")
    got = _run_port(d, ts.to_dict(), {"x": x}, [tf[0].name],
                    {"w_loop": w})
    np.testing.assert_allclose(got[0], 8 * (x @ w), **F32)
    prog = TF.Program.from_dict(d)
    from paddle_tpu_torch.fluid.executor import _analyze_block, _last_uses
    reads, _ = _analyze_block(prog.global_block(), ["x"])
    assert "w_loop" in reads
    frees = _last_uses(prog.global_block(), {tf[0].name})
    ops = prog.global_block().ops
    at = [k for k, o in enumerate(ops) if o.type == "while"][0]
    h = ops[[k for k, o in enumerate(ops) if o.type == "mul"][0]] \
        .output("Out")[0]
    assert h in frees[at]


def test_a_loop_reads_its_condition_once_an_iteration():
    tm, ts, tf = _build(TF, TU, _array_in_while_loop)
    exe, scope = TF.Executor(TF.CPUPlace()), TF.Scope()
    exe.run(ts, scope=scope)
    before = profiler.get_int_stats().get("control_flow_host_reads", 0)
    exe.run(tm, feed={"x": np.ones(2, "float32")},
            fetch_list=[v.name for v in tf], scope=scope)
    after = profiler.get_int_stats().get("control_flow_host_reads", 0)
    assert after - before == 6  # 5 iterations and the read that ends it


def test_random_ops_draw_fresh_bits_each_iteration():
    def build(fluid):
        L = fluid.layers
        arr = L.create_array("float32", capacity=3, element_shape=[4])
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, limit)
        with L.While(cond).block():
            L.array_write(L.uniform_random([4], "float32", -1.0, 1.0), i,
                          array=arr)
            L.increment_(i, 1)
            L.assign(L.less_than(i, limit), cond)
        return [_array_to_tensor(fluid, arr, "float32", use_stack=True)[0]]

    tm, ts, tf = _build(TF, TU, build)
    got = _run_port(tm.to_dict(), ts.to_dict(), {}, [tf[0].name])[0]
    assert got.shape == (3, 4) and np.abs(got).max() <= 1.0
    assert len({tuple(r) for r in got.tolist()}) == 3


def test_print_passes_its_input_through(capsys):
    def build(fluid):
        x = fluid.data("x", [2], "float32")
        return [fluid.layers.Print(x, message="seen")]

    jm, _, _ = _build(JF, JU, build)
    tm, ts, tf = _build(TF, TU, build)
    assert _json(tm) == _json(jm)
    assert T.static.Print is TF.layers.Print
    x = np.array([1.5, -2.0], "float32")
    got = _run_port(tm.to_dict(), ts.to_dict(), {"x": x}, [tf[0].name])
    np.testing.assert_array_equal(got[0], x)
    assert "seen" in capsys.readouterr().out


def test_eager_tensor_array_to_tensor():
    """nn.functional.tensor_array_to_tensor over an eager array (a list
    of tensors) against numpy; the reference hands its rule the list and
    raises."""
    xs = [np.random.RandomState(k).randn(2, 3).astype("float32")
          for k in range(3)]
    import torch

    for axis, stack in ((1, False), (0, False), (0, True)):
        out, idx = T.nn.functional.tensor_array_to_tensor(
            [torch.from_numpy(x) for x in xs], axis=axis, use_stack=stack)
        oracle = np.stack(xs) if stack else np.concatenate(xs, axis=axis)
        np.testing.assert_array_equal(out.numpy(), oracle)
        assert idx.tolist() == [2, 2, 2]
    with Jdy.guard():
        with pytest.raises(AttributeError):
            J.nn.functional.tensor_array_to_tensor(
                [J.to_tensor(x) for x in xs])
