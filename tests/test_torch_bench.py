"""The port's bench entry point and FLOP count on the CPU.

- ``observability.flops``: the forward FLOPs the port reads off its model
  instances equal, as integers, those the JAX package's formulas read off
  the Flax modules, for resnet_micro, resnet18, resnet50 and GPT-2-small;
  the peak table knows the H100 and no TPU, and ``$OBS_PEAK_FLOPS``
  overrides it; the percentile is the JAX package's.
- ``python -m distributed_training_tpu_torch.bench``: the root bench's
  parser (names and defaults), a bare run with ``--device cpu`` at a tiny
  size printing one JSON line per leg with the root bench's keys, the
  image leg's remat and bf16-parameter flags, ``--steps-per-call`` (N
  steps a call, the root's rounding of warm-up and steps and its message,
  the windows and throughput over steps × N, ``--cpu-offload`` forcing 1,
  the LM leg taking N on the card only), the LM leg's chunked and
  saved-probabilities CE, the data modes (``--data-only`` in each mode,
  ``--data-concurrent``) with the root bench's keys, and every flag the
  port cannot honour raising. The tiny runs pass ``--steps-per-call 1``
  (the default 15 would round 2 steps up to 15 a call, after 15 of
  warm-up) unless N is what they test.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.observability import flight_recorder
from distributed_training_tpu.observability import flops as jflops
from distributed_training_tpu_torch import bench
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.observability import (
    PEAK_BF16_FLOPS,
    device_peak_flops,
    forward_flops,
    mfu,
    percentile,
    train_step_flops,
)

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's JSON keys (its observability_fields and result dicts).
KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "model_flops_per_sec",
        "step_time_p50_ms", "step_time_p95_ms"}
GPT2_SMALL = dict(num_classes=50304, num_layers=12, num_heads=12, hidden_dim=768,
                  max_len=1024)


@pytest.mark.parametrize("name,size,classes", [
    ("resnet_micro", 32, 10), ("resnet18", 32, 10), ("resnet50", 224, 1000)])
def test_resnet_flops_equal_jax(name, size, classes):
    want = jflops.forward_flops(jax_model(name, num_classes=classes),
                                image_size=size, batch=512)
    got = forward_flops(get_model(name, num_classes=classes), image_size=size, batch=512)
    assert isinstance(got, int) and got == int(want) and float(got) == want
    assert train_step_flops(got) == 3 * got


def test_gpt2_small_flops_equal_jax():
    want = jflops.forward_flops(jax_model("transformer_lm", dtype=jnp.bfloat16, **GPT2_SMALL),
                                seq_len=1024, batch=16)
    with torch.device("meta"):  # the dims alone: no weights are made
        model = get_model("transformer_lm", dtype=torch.bfloat16, **GPT2_SMALL)
    got = forward_flops(model, seq_len=1024, batch=16)
    assert got == int(want) and float(got) == want


@pytest.mark.parametrize("experts", [8, (4,), (0, 8)], ids=["int", "tuple", "per_layer"])
def test_moe_lm_has_no_flop_count_as_in_jax(experts):
    """An LM with MoE layers gets no static FLOP count (so no MFU), as the
    JAX package's ``forward_flops``; all-zero counts are the dense model."""
    kw = dict(GPT2_SMALL, num_layers=4, moe_num_experts=experts)
    want = jflops.forward_flops(jax_model("transformer_lm", **kw), seq_len=1024)
    with torch.device("meta"):
        got = forward_flops(get_model("transformer_lm", **kw), seq_len=1024)
    assert want is None and got is None
    dense = dict(kw, moe_num_experts=0)
    with torch.device("meta"):
        assert forward_flops(get_model("transformer_lm", **dense), seq_len=1024) == int(
            jflops.forward_flops(jax_model("transformer_lm", **dense), seq_len=1024))


def test_resnet50_train_step_is_about_3x_8_2_gflop_an_image():
    step = train_step_flops(forward_flops(get_model("resnet50", num_classes=1000),
                                          image_size=224))
    assert 3 * 8.1e9 < step < 3 * 8.3e9


def test_peak_table_and_override(monkeypatch):
    assert PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": 989.4e12}
    monkeypatch.delenv("OBS_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_peak_flops() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert device_peak_flops() == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Other Card")
    assert device_peak_flops() is None
    monkeypatch.setenv("OBS_PEAK_FLOPS", "1e12")
    assert device_peak_flops() == 1e12
    assert mfu(5e11, 1, 1e12) == 0.5 and mfu(5e11, 1, None) is None


@pytest.mark.parametrize("values", [[3.0], [5.0, 1.0], [4.0, 2.5, 9.0, 1.0, 7.5]])
def test_percentile_is_the_jax_packages(values):
    for q in (0, 50, 95, 100):
        assert percentile(values, q) == flight_recorder.percentile(values, q)
    with pytest.raises(ValueError):
        percentile([], 50)


def _root_parser():
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_parser()


def test_parser_has_the_root_bench_names_and_defaults():
    root = vars(_root_parser().parse_args([]))
    port = vars(bench.build_parser().parse_args([]))
    assert set(port) == set(root) | {"device"}
    differ = {k for k in root if root[k] != port[k]}
    assert differ == set() and port["steps_per_call"] == 15


TINY = ["--device", "cpu", "--model", "resnet_micro", "--batch-size", "4",
        "--image-size", "32", "--num-classes", "10", "--warmup", "0", "--steps", "2",
        "--sync-interval", "1", "--lm-batch", "1", "--seq-len", "8",
        "--steps-per-call", "1"]


def test_bare_run_prints_both_legs_with_the_root_keys(capsys, monkeypatch):
    monkeypatch.setenv("OBS_PEAK_FLOPS", "1e12")
    results = bench.main(TINY)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == len(results) == 2
    image, lm = lines
    assert set(image) == set(lm) == KEYS
    assert image["unit"] == "images/sec/chip" and lm["unit"] == "tokens/sec"
    assert "resnet_micro" in image["metric"] and "accum:2" in image["metric"]
    assert "AdamW, B1 T8 flash" in lm["metric"]
    for line, (result, loss) in zip(lines, results):
        assert line == result and np.isfinite(loss)
        assert line["vs_baseline"] is None
        assert line["value"] > 0 and 0 < line["mfu"]
        assert line["step_time_p50_ms"] <= line["step_time_p95_ms"]


@pytest.mark.parametrize("flags,tag", [
    (["--zero-stage", "2", "--cpu-offload"], "zero-2, offload"),
    (["--zero-stage", "3", "--input-dtype", "uint8"], "zero-3, in:uint8"),
    (["--input-dtype", "bf16"], "in:bf16"),
], ids=["zero2_offload", "zero3_uint8", "bf16_input"])
def test_image_leg_honours_zero_offload_and_input_dtype(capsys, flags, tag):
    """``--zero-stage`` and ``--cpu-offload`` run PR 6's world-1 ZeRO
    path; ``--input-dtype`` sets the batch's dtype (uint8 mapped to float
    by the step)."""
    (line, loss), = bench.main([*TINY, "--image", *flags])
    assert tag in line["metric"] and line["value"] > 0 and np.isfinite(loss)


@pytest.mark.parametrize("flags", [
    ["--check"], ["--tp", "2"], ["--tp-overlap"],
], ids=lambda f: f[0])
def test_unported_flags_raise(flags, monkeypatch):
    """What the port's bench lacks raises naming ROADMAP.md. ``--tp``,
    ``--tp-overlap`` and ``--steps-per-call``, which this test once listed,
    are ported (the last in ``test_steps_per_call`` below): ``--tp 2``
    over one rank exits with the root bench's message (the check that
    ``--tp`` divides the ranks), and ``--tp-overlap`` at ``--tp 1`` runs
    the plain LM step (its GPT cut to one layer of width 32 here, as in
    the CE test below) with the root bench's tag."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if flags[0] == "--tp":
        with pytest.raises(SystemExit, match=r"--tp 2 must be >= 1 and divide the "
                                             r"device count \(= 1\)"):
            bench.main([*TINY, "--lm", *flags])
        return
    if flags[0] == "--tp-overlap":
        from distributed_training_tpu_torch import models

        get_model = models.get_model
        monkeypatch.setattr(models, "get_model", lambda name, **kw: get_model(
            name, **{**kw, "num_layers": 1, "num_heads": 2, "hidden_dim": 32}))
        (line, loss), = bench.main([*TINY, "--lm", "--steps", "1", *flags])
        assert ", tp-overlap," in line["metric"] and np.isfinite(loss)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.main(["--device", "cpu", *flags])


N_STEPS = [
    ("image", ["--image", "--steps-per-call", "3", "--warmup", "0", "--steps", "6"],
     3, 9, "bench: steps-per-call=3 rounds warmup 0->3 and steps 6->6 (one priming "
           "call always runs; pass --steps-per-call 1 for exact counts)"),
    ("cpu_offload", ["--image", "--steps-per-call", "3", "--zero-stage", "2",
                     "--cpu-offload"], 1, 2, "bench: --cpu-offload forces --steps-per-call 1"),
    ("lm_on_the_cpu", ["--lm", "--steps-per-call", "3"], 1, 2, None),
]


@pytest.mark.parametrize("leg,flags,n,steps,message", N_STEPS, ids=[c[0] for c in N_STEPS])
def test_steps_per_call(capsys, monkeypatch, leg, flags, n, steps, message):
    """``--steps-per-call N`` as the root bench takes it: the image leg runs
    N steps a call on the CPU too (``make_multi_step``'s loop; no priming
    step there), rounds ``--warmup`` and ``--steps`` to calls with the
    root's message when it rounds up, counts ``win`` and the throughput
    over steps × N (the step-time windows then match the rate, and the
    FLOPs per image stay one step's), and tags the metric
    ``steps/call:N``; ``--cpu-offload`` forces 1 with the root's message;
    the LM leg takes N on the card only (its GPT cut to one layer of width
    32 here)."""
    from distributed_training_tpu_torch import models
    from distributed_training_tpu_torch.train import lm_step, step as step_mod

    get_model, ran = models.get_model, [0]
    monkeypatch.setattr(models, "get_model", lambda name, **kw: get_model(
        name, **({**kw, "num_layers": 1, "num_heads": 2, "hidden_dim": 32}
                 if name == "transformer_lm" else kw)))
    for mod, name in ((step_mod, "make_train_step"), (lm_step, "make_lm_train_step")):
        def counted(make=getattr(mod, name), **kw):
            inner = make(**kw)

            def step(state, batch):
                ran[0] += 1
                return inner(state, batch)
            return step
        monkeypatch.setattr(mod, name, counted)
    argv = [*TINY[:-2], *flags] + ([] if "--steps" in flags else ["--steps", "2"])
    (line, loss), = bench.main(argv)
    err = capsys.readouterr().err
    assert ran[0] == steps and np.isfinite(loss) and line["value"] > 0
    assert (f", steps/call:{n}," in line["metric"]) == (n > 1)
    assert (message in err) if message else ("steps-per-call" not in err)
    if leg == "image":
        batch = 4
        assert line["step_time_p50_ms"] == pytest.approx(1e3 * batch / line["value"], rel=0.2)
        per_image = train_step_flops(forward_flops(
            get_model("resnet_micro", num_classes=10), image_size=32, batch=1))
        # rel 1e-3: ``value`` is rounded to 0.01 images/s; steps counted
        # once where the other counts steps × N would be off by 3×.
        assert line["model_flops_per_sec"] / line["value"] == pytest.approx(per_image, rel=1e-3)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_image_leg_runs_vit_b16(remat, monkeypatch):
    """``--model vit_b16`` runs the image leg with ViT (with and without
    ``--remat``, as the root bench does; its ViT cut to patch 8, width 32,
    one layer here), and counts its FLOPs (``mfu`` needs a peak, none on
    the CPU)."""
    from distributed_training_tpu_torch import models
    from distributed_training_tpu_torch.observability import flops

    get_model = models.get_model
    monkeypatch.setattr(models, "get_model", lambda name, **kw: get_model(
        name, **{**kw, "patch_size": 8, "hidden_size": 32, "num_layers": 1,
                 "num_heads": 2, "mlp_dim": 64}))
    flags = ["--model", "vit_b16", *(["--remat"] if remat else [])]
    (line, loss), = bench.main([*TINY[:2], *TINY[4:], "--image", *flags])
    assert line["metric"].startswith("vit_b16 synthetic-ImageNet")
    assert (", remat," in line["metric"]) == remat
    assert line["value"] > 0 and np.isfinite(loss) and line["mfu"] is None
    per_image = 3 * flops.vit_forward_flops(image_size=32, patch_size=8, hidden_size=32,
                                            num_layers=1, mlp_dim=64, num_classes=10)
    assert line["model_flops_per_sec"] / line["value"] == pytest.approx(per_image, rel=1e-2)


@pytest.mark.parametrize("flags,tag", [
    (["--remat"], ", remat,"),
    (["--remat-policy", "conv"], ", remat:conv,"),
    (["--param-dtype", "bf16"], ", params:bf16,"),
], ids=["remat", "remat_policy_conv", "param_dtype_bf16"])
def test_image_leg_runs_remat_and_bf16_params(capsys, flags, tag):
    """The image leg's remat flags build the ResNet with them, and
    ``--param-dtype bf16`` keeps its parameters and SGD momentum in bf16
    with float32 BatchNorm statistics, as the Flax model with
    ``param_dtype=bf16`` does; each tag is in the metric, as the root
    bench writes it."""
    (line, loss), = bench.main([*TINY, "--image", "--steps", "1", *flags])
    assert tag in line["metric"] and line["value"] > 0 and np.isfinite(loss)
    args = bench.build_parser().parse_args([*TINY, *flags])
    model, state, _, _ = bench.image_step(args, torch.device("cpu"))
    bf16 = "bf16" in flags
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16 if bf16 else torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert {t.dtype for t in state.opt_state.trace.values()} == {
        torch.bfloat16 if bf16 else torch.float32}
    assert model.remat and model.remat_policy == ("conv" if "conv" in flags else None) \
        or bf16 and not model.remat


@pytest.mark.parametrize("flags,tag,kw", [
    (["--ce-chunk", "4"], ", chunked CE,", dict(ce_chunk=4, ce_save_probs=False)),
    (["--ce-save-probs", "--logits-dtype", "fp32"], ", ce-probs,",
     dict(ce_chunk=None, ce_save_probs=True)),
], ids=["ce_chunk", "ce_save_probs"])
def test_lm_leg_runs_the_chunked_and_saved_probabilities_ce(monkeypatch, flags, tag, kw):
    """The flags reach the LM step (the arguments it is made with) and the
    metric. The leg's GPT is cut to one layer of width 32 here, its
    vocabulary kept: the full width's CPU step is the bare run's test."""
    from distributed_training_tpu_torch import models
    from distributed_training_tpu_torch.train import lm_step

    get_model, make_step, seen = models.get_model, lm_step.make_lm_train_step, {}

    def small(name, **model_kw):
        return get_model(name, **{**model_kw, "num_layers": 1, "num_heads": 2,
                                  "hidden_dim": 32})

    def step(**step_kw):
        seen.update(step_kw)
        return make_step(**step_kw)

    monkeypatch.setattr(models, "get_model", small)
    monkeypatch.setattr(lm_step, "make_lm_train_step", step)
    (line, loss), = bench.main([*TINY, "--lm", "--steps", "1", *flags])
    assert tag in line["metric"] and line["value"] > 0 and np.isfinite(loss)
    assert {k: seen[k] for k in kw} == kw


DATA = ["--data-images", "16", "--data-batch-size", "4", "--data-workers", "2",
        "--image-size", "16"]


@pytest.mark.parametrize("mode,extras", [
    ("imagefolder", set()), ("cached", set()), ("augment", set()),
    ("both", {"jpeg_decode_images_per_sec", "augment_images_per_sec"}),
])
def test_data_only_prints_the_root_keys(capsys, mode, extras):
    """``--data-only`` over a generated JPEG tree: one JSON line with the
    root bench's keys, the primary rate the cached path's when it ran,
    ``vs_baseline`` null (the root's device rate is a TPU's)."""
    (line, loss), = bench.main(["--data-only", "--data-mode", mode, *DATA])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == [line] and loss is None
    assert set(line) == {"metric", "value", "unit", "vs_baseline"} | extras
    assert line["unit"] == "images/sec (host)" and line["vs_baseline"] is None
    assert line["value"] > 0 and f"({mode};" in line["metric"]
    assert all(line[k] > 0 for k in extras)


def test_data_only_reads_a_given_tree(tmp_path):
    from torch_image_tree import write_tree

    root = write_tree(tmp_path / "tree")
    (line, _), = bench.main(["--data-only", "--data-mode", "cached", "--data-path", root,
                             *DATA])
    assert line["value"] > 0
    assert os.path.exists(os.path.join(root, ".decoded_cache", "train_16.npy"))
    with pytest.raises(SystemExit, match="does not exist"):
        bench.main(["--data-only", "--data-path", str(tmp_path / "none"), *DATA])


@pytest.mark.parametrize("stress", [True, False], ids=["stress", "no_stress"])
def test_data_concurrent_trains_on_the_decoded_cache(capsys, stress):
    """``--data-concurrent``: training on decoded-cache batches through the
    prefetcher, with the stress loader's spare host rate beside it."""
    argv = [*TINY, "--data-concurrent", "--steps", "3", "--warmup", "1", *DATA,
            "--batch-size", "4"]
    (line, loss), = bench.main(argv + ([] if stress else ["--no-data-stress"]))
    keys = {"metric", "value", "unit", "vs_baseline"}
    assert set(line) == keys | ({"spare_host_images_per_sec"} if stress else set())
    assert line["unit"] == "images/sec/chip" and line["vs_baseline"] is None
    assert line["value"] > 0 and np.isfinite(loss)
    assert ("stress loader" in line["metric"]) == stress
    if stress:
        assert line["spare_host_images_per_sec"] >= 0


def test_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--image"])
