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


def _port_files():
    return sorted(PORT.rglob("*.py")) + [SMOKE]


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
            "serving/engine.py", "models/bert.py", "convert.py"} <= names


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
            "paddle_tpu_torch.nn, paddle_tpu_torch.obs\n"
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
