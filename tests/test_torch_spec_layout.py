"""The port's spec rules and layouts (paddle_tpu_torch/parallel/
spec_rules.py, spec_layout.py, mesh.batch_spec) against the reference's,
in one process with no ranks:

* the cases of the reference's TestSpecRegistry
  (tests/test_spmd_sharding.py:49-140) run through both packages and
  give the same entries, problem strings, clamp counts and JSON;
* every parameter and accumulator of the static ResNet-50, CTR-DNN and
  tiny-transformer programs (each minimized with Adam, built by both
  packages) and every tensor of BERT-tiny's state resolves to the same
  spec on {data: 8}, {data: 2, fsdp: 2, tp: 2}, {fsdp: 4} and {tp: 8}
  (the reference's meshes over the conftest's 8 virtual devices, the
  port's over 8 ranks it does not start);
* the port's rule module is its own copy: the same source below the
  docstring, importing nothing of paddle_tpu.
"""

import inspect

import numpy as np
import pytest

from jax.sharding import PartitionSpec as JP_

import paddle_tpu.fluid as JF
from paddle_tpu import profiler as Jprof
from paddle_tpu.fluid import unique_name as JU
from paddle_tpu.jit import functional_state as jax_functional_state
from paddle_tpu.models import bert as JB
from paddle_tpu.models import resnet as JR
from paddle_tpu.parallel import mesh as Jmesh
from paddle_tpu.parallel import spec_layout as JL
from paddle_tpu.parallel import spec_rules as JS

import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch import profiler as Tprof
from paddle_tpu_torch.fluid import unique_name as TU
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.parallel import mesh as Tmesh
from paddle_tpu_torch.parallel import spec_layout as TL
from paddle_tpu_torch.parallel import spec_rules as TS

import torch_ctr_program as CTR
import torch_dist_worker as W

MESHES = [{"data": 8}, {"data": 2, "fsdp": 2, "tp": 2}, {"fsdp": 4},
          {"tp": 8}]


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    JL.clear_specs()
    TL.clear_specs()


def _meshes(axes):
    """(the reference's mesh, the port's) for `axes`."""
    import jax

    n = int(np.prod(list(axes.values())))
    return (Jmesh.make_mesh(dict(axes), devices=jax.devices()[:n]),
            Tmesh.make_mesh(dict(axes), devices=range(n)))


SPMD = {"data": 2, "fsdp": 2, "tp": 2}
DP = {"data": 8}


class _Ann:
    _sharding_axes = ("fsdp", "data")


# (mesh, name, shape, annotated?) of the registry's resolution cases
SPEC_CASES = [
    (SPMD, "fc_0.w_0", (16, 64), False),
    (SPMD, "fc_0.w_0_moment1_0", (16, 64), False),
    (SPMD, "fc_0.b_0", (64,), False),
    (SPMD, "layer_norm_0.w_0", (64,), False),
    (SPMD, "fc_0.w_0_beta1_pow_acc_0", (1,), False),
    (SPMD, "learning_rate_0", (1,), False),
    (SPMD, "embedding_0.w_0", (32, 16), False),
    (DP, "fc_0.w_0", (16, 64), False),
    (DP, "embedding_0.w_0", (32, 16), False),
    (DP, "fc_0.w_0_moment1_0", (16, 64), False),
    (SPMD, "fc_9.w_0", (5, 7), False),
    (SPMD, "g", (16, 4), True),
    (DP, "g", (16, 4), True),
]


@pytest.mark.parametrize("axes,name,shape,ann", SPEC_CASES)
def test_spec_for_is_the_references(axes, name, shape, ann):
    jm, tm = _meshes(axes)
    var = _Ann() if ann else None
    want = JL.spec_for(name, shape, jm, var=var)
    got = TL.spec_for(name, shape, tm, var=var)
    assert tuple(got) == tuple(want)
    assert repr(got) == repr(want) and str(got) == str(want)


def test_the_registrys_answers_are_the_references_own():
    """The reference's expected answers (test_spmd_sharding.py:50-111),
    asserted on the port."""
    _, tm = _meshes(SPMD)
    _, dm = _meshes(DP)
    P = TL.P
    assert TL.spec_for("fc_0.w_0", (16, 64), tm) == P("fsdp", "tp")
    assert TL.spec_for("embedding_0.w_0", (32, 16), tm) == P(("fsdp", "tp"))
    assert TL.spec_for("fc_9.w_0", (5, 7), tm) == P()
    assert TL.spec_for("g", (16, 4), tm, var=_Ann()) == P("fsdp")
    assert TL.spec_for("g", (16, 4), dm, var=_Ann()) == P("data")


def test_overrides_win_clamp_and_clear_as_the_references(caplog):
    (jm, tm) = _meshes(SPMD)
    answers = []
    for L, m, spec, prof in ((JL, jm, JP_, Jprof), (TL, tm, TL.P, Tprof)):
        before = prof.get_int_stats().get("spec_clamped", 0)
        L.register_spec("custom.w", spec("tp", "fsdp"))
        L.register_spec("custom.v", spec("pipe"))
        got = [tuple(L.spec_for("custom.w", (16, 64), m)),
               tuple(L.spec_for("custom.v", (16,), m)),
               tuple(L.spec_for("custom.v", (16,), m))]
        L.register_spec("custom.w", None)
        got.append(sorted(L.registered_specs()))
        got.append(prof.get_int_stats().get("spec_clamped", 0) - before)
        answers.append(got)
    assert answers[1] == answers[0]
    assert answers[1] == [("tp", "fsdp"), (), (), ["custom.v"], 2]
    # one log line a name, however often it clamps
    lines = [r for r in caplog.records
             if r.name == TL.logger.name and "custom.v" in r.getMessage()]
    assert len(lines) == 1 and "'pipe'" in lines[0].getMessage()


@pytest.mark.parametrize("spec,shape", [
    (("fsdp", "tp"), (16, 64)), (("pipe",), (16,)), (("fsdp",), (5,)),
    (("fsdp", "tp"), (16,)), ((("fsdp", "tp"),), (12, 3)),
    ((None, "tp"), (4, 6))])
def test_validate_spec_problem_strings_are_the_references(spec, shape):
    jm, tm = _meshes(SPMD)
    assert TL.validate_spec(TL.P(*spec), shape, tm) == \
        JL.validate_spec(JP_(*spec), shape, jm)


def test_batch_spec_composes_data_and_fsdp_as_the_references():
    jm, tm = _meshes(SPMD)
    jd, td = _meshes(DP)
    for rows in (16, 6, 5, 2):
        assert tuple(Tmesh.batch_spec(tm, rows)) == \
            tuple(Jmesh.batch_spec(jm, rows))
    assert tuple(Tmesh.batch_spec(td, 16)) == ("data",)
    assert tuple(Tmesh.batch_spec(tm, 16)) == (("data", "fsdp"),)


@pytest.mark.parametrize("spec", [("fsdp", "tp"), (("fsdp", "tp"),),
                                  (None, "tp"), ()])
def test_spec_json_roundtrip_is_the_references(spec):
    doc = TL.spec_to_json(TL.P(*spec))
    assert doc == JL.spec_to_json(JP_(*spec))
    assert TL.spec_from_json(doc) == TL.P(*spec)
    assert tuple(TL.spec_from_json(doc)) == tuple(JL.spec_from_json(doc))
    assert TL.spec_to_json(None) is None


def test_spec_rules_is_the_ports_own_copy():
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]

    assert body(TS) == body(JS)
    assert "paddle_tpu." not in body(TS) and "jax" not in body(TS)


def test_placements_follow_the_mesh_order():
    """A tuple entry must name its axes in the mesh's order: DTensor
    splits a dim over several mesh dims in that order."""
    from torch.distributed.tensor import Replicate, Shard

    _, tm = _meshes(SPMD)
    assert TL.placements(TL.P("fsdp", "tp"), tm) == (
        Replicate(), Shard(0), Shard(1))
    assert TL.placements(TL.P(("fsdp", "tp")), tm) == (
        Replicate(), Shard(0), Shard(0))
    with pytest.raises(ValueError, match="axis order"):
        TL.placements(TL.P(("tp", "fsdp")), tm)
    with pytest.raises(ValueError, match="not an axis"):
        TL.placements(TL.P("pipe"), tm)


# -- the sweep over real programs and states ------------------------------------

def _resnet(fluid, R, U):
    with U.guard():
        main, *_ = R.build_train_program(
            depth=50, class_num=1000, image_shape=(3, 224, 224),
            optimizer=fluid.optimizer.Adam(0.001))
    return main


def _ctr(fluid, R, U):
    return CTR.build(fluid, CTR.SMALL)[0]


def _tiny(fluid, R, U):
    return W.tiny_program(fluid, U)[0]


def _persistables(main):
    return {n: v for n, v in main.global_block().vars.items()
            if v.persistable and v.shape and all(d >= 0 for d in v.shape)}


@pytest.fixture(scope="module")
def programs():
    out = {}
    for tag, build in (("resnet50", _resnet), ("ctr", _ctr),
                       ("tiny", _tiny)):
        out[tag] = (build(JF, JR, JU), build(TF, TR, TU))
    return out


@pytest.mark.parametrize("tag", ["resnet50", "ctr", "tiny"])
def test_every_program_var_resolves_alike(programs, tag):
    jmain, tmain = programs[tag]
    jv, tv = _persistables(jmain), _persistables(tmain)
    assert sorted(tv) == sorted(jv)
    assert any("_moment1_" in n for n in tv)
    split = 0
    for axes in MESHES:
        jm, tm = _meshes(axes)
        for n in sorted(tv):
            want = JL.spec_for(n, jv[n].shape, jm, var=jv[n])
            got = TL.spec_for(n, tv[n].shape, tm, var=tv[n])
            assert tuple(got) == tuple(want), (axes, n)
            split += bool(tuple(got))
    assert split  # some var is split on some mesh


def test_every_bert_tensor_resolves_alike():
    import paddle_tpu as JPK
    import paddle_tpu.fluid.initializer as Jinit

    saved = list(Jinit._eager_seed)
    try:
        JPK.seed(0)
        jstate = jax_functional_state(JB.BertForPretraining(
            JB.BertConfig.tiny()))
    finally:
        Jinit._eager_seed[:] = saved
    from paddle_tpu_torch.jit import functional_state

    tstate = functional_state(TB.BertForPretraining(TB.BertConfig.tiny(),
                                                    device="cpu"))
    assert sorted(tstate) == sorted(jstate)
    for axes in MESHES:
        jm, tm = _meshes(axes)
        for n in sorted(tstate):
            shape = tuple(tstate[n].shape)
            assert shape == tuple(jstate[n].shape)
            for acc in ("", "_moment1_0"):
                assert tuple(TL.spec_for(n + acc, shape, tm)) == \
                    tuple(JL.spec_for(n + acc, shape, jm)), (axes, n)
            assert tuple(TB.bert_param_spec(n, shape, "mp")) == \
                tuple(JB.bert_param_spec(n, shape, "mp")), n
