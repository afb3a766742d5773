"""The 2.x inference path (`paddle_tpu_torch.inference`) against
paddle_tpu.inference on the CPU.

- A 2-layer BERT (BertConfig.tiny, dropout 0) carried across with
  convert.load_jax_state, exported by each package over the same
  (4, 16) inputs and loaded into each package's Predictor: outputs within
  TOL for the export's batch and for a smaller, padded one, with the
  weights folded and with `.pdiparams`; the two manifests have the same
  keys (only `format`'s value differs).  f32 on both sides through two
  encoder layers: measured ~1e-6.
- A cipher round trip gives the unencrypted predictor's bits; a missing
  key raises; the AES framing crosses packages.
- The exported graph holds the kernels' operators
  (`paddle_tpu_torch::flash_forward` a layer, `::ffn_act_fwd` a layer
  under the default FFN arm, `::ffn_forward` under `enable_fused_ffn`),
  not the plain versions' ops; each operator equals its plain version
  bit for bit on the CPU.
- A Predictor asked to run on another device than its graph's raises and
  names both; the Config's serving knobs reach the bucketed runner.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu import inference as JI
from paddle_tpu.jit import functional_state
from paddle_tpu.models import bert as JB

import paddle_tpu_torch as T
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.ops.kernels import attention as A
from paddle_tpu_torch.ops.kernels import ffn as F

TOL = dict(atol=1e-5, rtol=1e-5)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, S = 4, 16


class _JBert(J.nn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, types, mask):
        return self.m(ids, types, attention_mask=(mask != 0)[:, None, None, :])


class _TBert(T.nn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, types, mask):
        return self.m(ids, types, attention_mask=(mask != 0)[:, None, None, :])


def _feeds(rows, seed):
    b = JB.fake_batch(JB.BertConfig.tiny(), rows, S, seed=seed)
    return [b["input_ids"], b["token_type_ids"], b["attention_mask"]]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each package's export of the same weights, folded and not:
    {(package, fold): prefix}."""
    d = tmp_path_factory.mktemp("inference")
    J.seed(23)
    jm = JB.BertModel(JB.BertConfig.tiny(**NO_DROP))
    jm.eval()
    state = {k: np.asarray(v) for k, v in functional_state(jm).items()}
    tm = load_jax_state(TB.BertModel(TB.BertConfig.tiny(**NO_DROP),
                                     device="cpu"), state).eval()
    spec = _feeds(B, 0)
    out = {}
    for fold in (True, False):
        tag = "fold" if fold else "params"
        out["reference", fold] = JI.save_inference_model(
            str(d / f"j_{tag}"), _JBert(jm), spec, fold_params=fold)
        out["port", fold] = TI.save_inference_model(
            str(d / f"t_{tag}"), _TBert(tm), spec, fold_params=fold)
    out["module"] = _TBert(tm)
    return out


@pytest.mark.parametrize("rows", [B, 3])
@pytest.mark.parametrize("fold", [True, False])
def test_the_predictor_matches_the_references(exported, fold, rows):
    feeds = _feeds(rows, 5)
    want = JI.load_inference_model(exported["reference", fold]).run(feeds)
    got = TI.load_inference_model(exported["port", fold],
                                  device="cpu").run(feeds)
    assert [g.shape for g in got] == [w.shape for w in want] \
        == [(rows, S, 64), (rows, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("fold", [True, False])
def test_the_manifests_have_the_same_keys(exported, fold):
    j, t = (json.load(open(exported[p, fold] + ".json"))
            for p in ("reference", "port"))
    assert set(j) == set(t)
    assert (j["format"], t["format"]) == ("stablehlo", TI.FORMAT)
    for k in ("encrypted", "cipher", "fold_params", "inputs",
              "params_file"):
        assert j[k] == t[k] or (k == "params_file" and j[k].split(
            "_")[-1] == t[k].split("_")[-1]), k


def test_a_cipher_round_trip(exported, tmp_path):
    from paddle_tpu.inference.crypto import AESCipher as JAES
    from paddle_tpu_torch.inference.crypto import AESCipher, CipherUtils

    key = CipherUtils.gen_key(256)
    prefix = TI.save_inference_model(str(tmp_path / "enc"),
                                     exported["module"], _feeds(B, 0),
                                     key=key)
    manifest = json.load(open(prefix + ".json"))
    assert manifest["encrypted"] and manifest["cipher"] == "AESCipher:CTR"
    with pytest.raises(ValueError, match="set_cipher"):
        TI.create_predictor(TI.Config(prefix, device="cpu"))
    cfg = TI.Config(prefix, device="cpu")
    cfg.set_cipher(key)
    feeds = _feeds(B, 9)
    plain = TI.load_inference_model(exported["port", True], device="cpu")
    for g, w in zip(TI.create_predictor(cfg).run(feeds), plain.run(feeds)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError, match="PLAINTEXT"):
        TI.save_inference_model(str(tmp_path / "x"), exported["module"],
                                _feeds(B, 0), fold_params=False, key=key)
    for mode in ("CTR", "GCM"):
        blob = os.urandom(100)
        assert AESCipher(mode).decrypt(JAES(mode).encrypt(blob, key),
                                       key) == blob
        assert JAES(mode).decrypt(AESCipher(mode).encrypt(blob, key),
                                  key) == blob


def _targets(prefix):
    ep = TI.load_inference_model(prefix, device="cpu")._exported
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def test_the_graph_holds_the_kernel_operators(exported):
    targets = _targets(exported["port", True])
    assert targets.count("paddle_tpu_torch.flash_forward.default") == 2
    assert targets.count("paddle_tpu_torch.ffn_act_fwd.default") == 2
    assert "paddle_tpu_torch.ffn_forward.default" not in targets
    # the plain versions' softmax and erf are inside the operators only
    for plain in ("aten.exp.default", "aten.amax.default",
                  "aten.erf.default"):
        assert plain not in targets, plain


def test_the_fused_arm_exports_the_ffn_kernel_operator(tmp_path,
                                                       monkeypatch):
    """enable_fused_ffn: a bf16 FFN at a width the kernel takes is traced
    as `paddle_tpu_torch::ffn_forward` (its plain version on the CPU)."""

    class FFN(T.nn.Layer):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(1)
            for name, shape in (("w1", (128, 256)), ("b1", (256,)),
                                ("w2", (256, 128)), ("b2", (128,))):
                setattr(self, name, torch.nn.Parameter(
                    (torch.randn(shape, generator=g) * 0.05).to(
                        torch.bfloat16)))

        def forward(self, x):
            return F.fused_ffn(x.to(torch.bfloat16), self.w1, self.b1,
                               self.w2, self.b2)

    x = np.random.RandomState(0).randn(8, 128).astype("float32")
    monkeypatch.setattr(F, "_FFN_DISABLED", None)  # enable_fused_ffn()
    prefix = TI.save_inference_model(str(tmp_path / "ffn"), FFN(), [x])
    targets = _targets(prefix)
    assert targets.count("paddle_tpu_torch.ffn_forward.default") == 1
    assert "paddle_tpu_torch.ffn_act_fwd.default" not in targets
    (got,) = TI.load_inference_model(prefix, device="cpu").run([x])
    m = FFN()
    want = F.ffn_forward_reference(torch.from_numpy(x).to(torch.bfloat16),
                                   m.w1, m.b1, m.w2, m.b2)
    np.testing.assert_array_equal(got, want.float().numpy())


def _flash_case(g):
    q, k, v = (torch.randn(2, 24, 3, 16, generator=g).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.where(torch.rand(2, 24, generator=g) < 0.2, -1e9, 0.0)
    return (torch.ops.paddle_tpu_torch.flash_forward(
        q, k, v, bias, 77, True, 0, 0.25, 0.1),
        A.flash_forward_reference(q, k, v, bias, 77, True, 0, 0.25, 0.1))


def _ffn_case(g):
    x, w1, b1, w2, b2 = (torch.randn(*s, generator=g) for s in
                         ((16, 32), (32, 64), (64,), (64, 32), (32,)))
    return (torch.ops.paddle_tpu_torch.ffn_forward(x, w1, b1, w2, b2, "relu",
                                                   0.1, 5),
            F.ffn_forward_reference(x, w1, b1, w2, b2, "relu", 0.1, 5))


def _act_case(g):
    pre, b1 = torch.randn(16, 64, generator=g), torch.randn(64, generator=g)
    return (torch.ops.paddle_tpu_torch.ffn_act_fwd(pre, b1, "gelu", 0.1, 9),
            F.ffn_act_fwd_reference(pre, b1, "gelu", 0.1, 9))


@pytest.mark.parametrize("case", [_flash_case, _ffn_case, _act_case],
                         ids=["flash_forward", "ffn_forward", "ffn_act_fwd"])
def test_each_operator_is_its_plain_version_bit_for_bit(case):
    got, want = case(torch.Generator().manual_seed(3))
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_a_predictor_on_another_device_raises(exported, monkeypatch):
    monkeypatch.setattr(TI, "_traced_device",
                        lambda ep: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="traced on cuda:0 and this "
                                           "Predictor runs on cpu"):
        TI.load_inference_model(exported["port", True], device="cpu")


def test_the_config_knobs_reach_the_runner(exported):
    cfg = TI.Config(exported["port", True], device="cpu")
    cfg.enable_memory_optim()
    cfg.switch_ir_optim(False)
    p = TI.create_predictor(cfg)
    with pytest.warns(UserWarning, match="fixed batch dim"):
        runner = p._bucketed_runner()
    assert runner.donate and runner.bucketed and runner.buckets == [B]
    assert p.get_input_names() == ["x0", "x1", "x2"]
    h = p.run_handles(_feeds(2, 1))
    assert [x.shape for x in h] == [(2, S, 64), (2, 64)]
    assert T.static.load_inference_model is TI.load_inference_model
