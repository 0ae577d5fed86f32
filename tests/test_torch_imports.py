"""The port stands alone: no module of ``distributed_training_tpu_torch``
and no line of ``chip_smoke.py`` imports JAX, Flax, optax, orbax or the
JAX package; and the entry points refuse to run on the CPU unless asked."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import distributed_training_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "distributed_training_tpu")


def _port_files():
    root = os.path.dirname(port.__file__)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", list(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_every_module_imports_with_jax_blocked():
    mods = [m.name for m in pkgutil.walk_packages(port.__path__, "distributed_training_tpu_torch.")]
    code = (
        "import sys\n"
        "for name in %r: sys.modules[name] = None\n"
        "import importlib\n"
        "for m in %r: importlib.import_module(m)\n"
        "import distributed_training_tpu_torch as p\n"
        "p.Trainer, p.TrainConfig\n"
        "assert not any(k.split('.')[0] in %r for k, v in sys.modules.items() if v is not None)\n"
    ) % (FORBIDDEN, mods, FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 15


def test_trainer_without_device_raises_without_cuda(monkeypatch, tmp_path):
    from distributed_training_tpu_torch.config import DataConfig, TrainConfig
    from distributed_training_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(model="resnet_micro",
                      data=DataConfig(dataset="synthetic_cifar", batch_size=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.Trainer(cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_fp32_math_turns_tf32_off():
    from distributed_training_tpu_torch.utils.device import set_fp32_math

    torch.backends.cudnn.allow_tf32 = True
    set_fp32_math()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
