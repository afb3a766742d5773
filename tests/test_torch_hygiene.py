"""The port stands alone: no file of paddle_tpu_torch/, and not
chip_smoke.py, imports jax, jaxlib or paddle_tpu; importing the port
loads none of them; and chip_smoke.py refuses to report a result without
a GPU or without the repository around it."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


# JAX-free helpers of the tests that chip_smoke.py imports too
PROGRAMS = [ROOT / "tests" / "torch_seq2seq_program.py",
            ROOT / "tests" / "torch_seq2seq_static_program.py",
            ROOT / "tests" / "torch_srl_program.py",
            ROOT / "tests" / "torch_book_programs.py",
            ROOT / "tests" / "torch_cyclegan_program.py",
            ROOT / "tests" / "torch_ctr_program.py",
            ROOT / "tests" / "torch_ckpt_worker.py"]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE] + PROGRAMS


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(ln, m) for ln, m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_whole_package():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"ops/kernels/attention.py", "ops/kernels/ffn.py",
            "ops/kernels/probe.py", "tools/kernel4d_probe.py",
            "serving/engine.py", "serving/kv_cache.py", "models/bert.py",
            "convert.py", "jit.py", "fluid/framework.py",
            "fluid/executor.py", "fluid/backward.py", "fluid/optimizer.py",
            "fluid/layers/nn.py", "ops/registry.py", "ops/nn_ops.py",
            "models/resnet.py", "models/mnist.py",
            "models/transformer_wmt.py", "ops/rnn_ops.py",
            "nn/layer/transformer.py", "nn/layer/layers.py",
            "nn/layer/loss.py", "optimizer/__init__.py",
            "optimizer/lr.py", "io/__init__.py", "metric/__init__.py",
            "amp/__init__.py", "hapi/model.py", "hapi/callbacks.py",
            "tensor/__init__.py", "fluid/dygraph/__init__.py",
            "framework_io.py", "nn/layer/rnn.py", "nn/decode.py",
            "ops/math_ops.py", "ops/tensor_ops.py", "ops/sequence_ops.py",
            "fluid/layers/compat.py", "fluid/layers/rnn.py",
            "fluid/layers/learning_rate_scheduler.py",
            "fluid/layers/sequence_lod.py", "static/__init__.py",
            "static/nn.py", "ops/vision_ops.py", "ops/misc_ops.py",
            "nn/functional/__init__.py", "nn/functional/extra.py",
            "nn/layer/extra_layers.py", "nn/layer/container.py",
            "vision/models.py", "ops/control_flow_ops.py",
            "fluid/layers/control_flow.py", "fluid/dygraph/varbase.py",
            "fluid/dygraph/math_op_patch.py", "fluid/dygraph/nn.py",
            "core_native/__init__.py", "inference/c_bridge.py", "reader.py",
            "batch.py", "fluid/contrib/reader/__init__.py",
            "vision/datasets.py", "text/__init__.py", "text/datasets.py",
            "dataset/__init__.py", "dataset/_shim.py", "dataset/common.py",
            "dataset/image.py", "dataset/mnist.py", "dataset/cifar.py",
            "dataset/flowers.py", "dataset/voc2012.py", "dataset/imdb.py",
            "dataset/imikolov.py", "dataset/movielens.py",
            "dataset/uci_housing.py", "dataset/conll05.py",
            "dataset/wmt14.py", "dataset/wmt16.py"} <= names


def test_the_c_abi_reaches_only_the_ports_bridge():
    """csrc/c_api.cc imports one Python module, the port's bridge, and
    names no module of the reference."""
    import re

    src = (PORT / "csrc" / "c_api.cc").read_text()
    imported = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src)
    assert imported == ["paddle_tpu_torch.inference.c_bridge"]
    named = set(re.findall(r"\bpaddle_tpu(?:_torch)?\.[\w.]+", src))
    assert named and all(n.startswith("paddle_tpu_torch.") for n in named)


def _run(code_or_args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models.bert, paddle_tpu_torch.convert, "
            "paddle_tpu_torch.nn, paddle_tpu_torch.obs, "
            "paddle_tpu_torch.jit, paddle_tpu_torch.tools.kernel4d_probe, "
            "paddle_tpu_torch.fluid, paddle_tpu_torch.models.resnet, "
            "paddle_tpu_torch.models.mnist, paddle_tpu_torch.ops.registry, "
            "paddle_tpu_torch.models.transformer_wmt, "
            "paddle_tpu_torch.ops.rnn_ops, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.io, "
            "paddle_tpu_torch.metric, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.hapi, paddle_tpu_torch.hapi.callbacks, "
            "paddle_tpu_torch.tensor, paddle_tpu_torch.fluid.dygraph, "
            "paddle_tpu_torch.framework_io, paddle_tpu_torch.nn.layer.loss, "
            "paddle_tpu_torch.nn.layer.rnn, paddle_tpu_torch.nn.decode, "
            "paddle_tpu_torch.nn.functional.extra, "
            "paddle_tpu_torch.ops.vision_ops, "
            "paddle_tpu_torch.vision.models, "
            "paddle_tpu_torch.ops.control_flow_ops, "
            "paddle_tpu_torch.fluid.dygraph.nn, "
            "paddle_tpu_torch.core_native, "
            "paddle_tpu_torch.inference.c_bridge, paddle_tpu_torch.reader, "
            "paddle_tpu_torch.batch, paddle_tpu_torch.vision.datasets, "
            "paddle_tpu_torch.text.datasets, paddle_tpu_torch.dataset.mnist, "
            "paddle_tpu_torch.dataset.image, "
            "paddle_tpu_torch.fluid.contrib.reader\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_seq2seq_program, torch_cyclegan_program, "
            "torch_seq2seq_static_program\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\n")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _no_ok_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return not json.loads(lines[-1]).get("ok")
    except ValueError:
        return True


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    r = _run([str(SMOKE)], cwd=ROOT)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)
