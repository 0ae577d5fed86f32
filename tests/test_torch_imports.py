"""The port stands alone: no module of ``distributed_training_tpu_torch``
(``serving/`` included) and no line of ``chip_smoke.py`` or of the CLIs
(``resnet/torch_cuda/train.py``, ``gpt/torch_cuda/train.py``,
``gpt/torch_cuda/serve.py``) imports JAX,
Flax, optax, orbax or the JAX package; and the entry points refuse to run
on the CPU unless asked."""

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
    yield os.path.join(REPO, "resnet", "torch_cuda", "train.py")
    yield os.path.join(REPO, "gpt", "torch_cuda", "train.py")
    yield os.path.join(REPO, "gpt", "torch_cuda", "serve.py")


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
        "p.Trainer, p.LMTrainer, p.TrainConfig\n"
        "assert not any(k.split('.')[0] in %r for k, v in sys.modules.items() if v is not None)\n"
    ) % (FORBIDDEN, mods, FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 28
    for new in ("ops.flash_attention", "parallel.ring_attention", "models.gpt",
                "data.lm_text", "train.lm_step", "train.lm_trainer",
                "ops.conv3x3_stats", "tools.flash_kernel_bench",
                "tools.conv_fusion_probe", "runtime.distributed",
                "runtime.coordinator", "parallel.zero", "observability",
                "observability.flops", "bench", "utils.metrics_io",
                "utils.profiling", "runtime.preemption", "resilience",
                "resilience.async_ckpt", "ops.native", "ops.native.native",
                "data.imagefolder", "data.decoded_cache", "data.prefetch",
                "resilience.retry", "serving", "serving.engine", "serving.queue",
                "serving.scheduler", "serving.pages", "serving.request",
                "serving.ledger", "serving.metrics", "serving.timeseries",
                "serving.prefix_cache", "serving.speculative", "serving.quantize",
                "serving.journal", "serving.hotswap", "serving.alerts", "serving.httpbody",
                "serving.frontend", "serving.router", "serving.supervisor",
                "tools.traffic", "tools.serve_bench", "tools.serve_net", "tools.fleet_trace",
                "tools.incident_report", "tools.profile_step", "utils.collectives",
                "tools.collective_accounting"):
        assert f"distributed_training_tpu_torch.{new}" in mods


def test_the_clis_import_with_jax_blocked():
    """Both CLIs load as modules (parsers built, configs made for their
    defaults) in a process where importing JAX or the JAX package fails,
    and leave neither in ``sys.modules``."""
    code = (
        "import sys, importlib.util\n"
        "for name in %r: sys.modules[name] = None\n"
        "for i, path in enumerate(%r):\n"
        "    spec = importlib.util.spec_from_file_location(f'cli{i}', path)\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        "    m.build_config(m.build_parser().parse_args([]))\n"
        "assert not any(k.split('.')[0] in %r for k, v in sys.modules.items() if v is not None)\n"
    ) % (FORBIDDEN, [os.path.join(REPO, d, "torch_cuda", "train.py") for d in ("resnet", "gpt")],
         FORBIDDEN)
    r = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_serve_cli_imports_with_jax_blocked():
    """``gpt/torch_cuda/serve.py`` loads and parses its defaults (the card
    as the device), the serving features' flags (``--spec-k``,
    ``--prefix-cache``, ...) and the control room's (``--metrics-port``,
    ``--slo-rules``, ``--incident-dir``), and the fleet's modules and the
    serving tools import and parse their defaults (the card as the
    device), in a process where importing JAX or the JAX package fails."""
    code = (
        "import sys, importlib.util\n"
        "for name in %r: sys.modules[name] = None\n"
        "spec = importlib.util.spec_from_file_location('serve', %r)\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "assert m.build_parser().parse_args([]).device == 'cuda'\n"
        "a = m.build_parser().parse_args(['--spec-k', '2', '--prefix-cache', '--spec-drafter',\n"
        "                                 'gpt', '--quantize-weights', '--kv-dtype', 'int8'])\n"
        "assert a.spec_k == 2 and a.prefix_cache\n"
        "a = m.build_parser().parse_args(['--metrics-port', '0', '--slo-rules', 'default',\n"
        "                                 '--incident-dir', 'inc'])\n"
        "assert (a.metrics_port, a.slo_rules, a.incident_dir) == (0, 'default', 'inc')\n"
        "import distributed_training_tpu_torch.serving.speculative\n"
        "import distributed_training_tpu_torch.serving.prefix_cache\n"
        "import distributed_training_tpu_torch.serving\n"
        "from distributed_training_tpu_torch.serving import (AlertEngine, ServingFrontend,\n"
        "    Router, RouterFrontDoor, ReplicaSupervisor, parse_slo_rules)\n"
        "from distributed_training_tpu_torch.serving.httpbody import read_body\n"
        "from distributed_training_tpu_torch.observability.exporter import attach_engine\n"
        "from distributed_training_tpu_torch.tools import (serve_bench, serve_net, traffic,\n"
        "    fleet_trace, incident_report, profile_step)\n"
        "for tool in (serve_bench, serve_net, profile_step):\n"
        "    assert tool.build_parser().parse_args([]).device == 'cuda'\n"
        "assert len(traffic.SCENARIOS) == 9 and len(parse_slo_rules('default')) == 7\n"
        "assert not any(k.split('.')[0] in %r for k, v in sys.modules.items() if v is not None)\n"
    ) % (FORBIDDEN, os.path.join(REPO, "gpt", "torch_cuda", "serve.py"), FORBIDDEN)
    r = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_gpt_cli_without_device_raises_without_cuda(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gpt_cli", os.path.join(REPO, "gpt", "torch_cuda", "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--num-layers", "1", "--hidden-dim", "16", "--num-heads", "2"])


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
