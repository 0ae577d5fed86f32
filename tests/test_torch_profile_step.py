"""``python -m distributed_training_tpu_torch.tools.profile_step``: the
artifact carries the JAX tool's keys, ``--summarize`` prints its tables
from an artifact the test writes, kernels fall in their categories, and a
capture of the bench's step runs on the CPU (its rows the CPU's
operators, the artifact saying ``cpu``)."""

import contextlib
import io
import json
import os

import pytest

from distributed_training_tpu_torch.tools import profile_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"label", "trace_steps", "device", "num_steps", "step_time_ms",
            "op_time_ms_per_step", "categories", "top_ops"}


@pytest.mark.parametrize("name", ["r50_b256", "torch_r50_b256", "torch_gpt_t1024"])
def test_the_committed_profiles_have_the_jax_keys(name):
    with open(os.path.join(REPO, "profiles", f"{name}.json")) as fh:
        art = json.load(fh)
    assert JAX_KEYS <= set(art)
    if name.startswith("torch_"):  # the card's name and power limit
        assert art["device"]["card"].startswith("NVIDIA H100")


@pytest.mark.parametrize("name,cat", [
    ("void flash_wgmma::bwd_kernel<__nv_bfloat16, 64, true>(...)", "flash attention (K2-K4)"),
    ("fused_adam_kernel(float*, ...)", "fused adam (K1)"),
    ("void conv_wgmma::conv_kernel<__nv_bfloat16, 64>", "conv3x3+stats (K5)"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel", "batchnorm"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "batchnorm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "convolution"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "copy / memset"),
    ("void at::native::index_select_large_index", "gather / scatter / index"),
    ("something_else", "other"),
])
def test_kernel_categories(name, cat):
    assert profile_step.category(name) == cat


def test_summarize_prints_an_artifact(tmp_path):
    rows = [("nvjet_tst_256x128", 3000.0, 6), ("void flash_wgmma::fwd_kernel", 600.0, 24),
            ("vectorized_elementwise_kernel<4>", 1200.0, 300)]
    art = {"label": "gpt2s_T1024_B16_flash", "trace_steps": 3, "num_steps": 3,
           "step_time_ms": 2.0,
           "device": {"type": "NVIDIA H100 80GB HBM3", "card": "NVIDIA H100 80GB HBM3, 700.00 W",
                      "peak_tflops": 989.0, "peak_hbm_gbps": 3350.0},
           **profile_step.aggregate(rows, 3, top=2)}
    assert JAX_KEYS <= set(art)
    assert art["op_time_ms_per_step"] == pytest.approx(1.6)
    assert list(art["categories"]) == ["matmul", "elementwise", "flash attention (K2-K4)"]
    assert [o["name"] for o in art["top_ops"]] == ["nvjet_tst_256x128",
                                                   "vectorized_elementwise_kernel<4>"]
    path = tmp_path / "a.json"
    path.write_text(json.dumps(art))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert profile_step.main(["--summarize", str(path), "--top", "2"]) == 0
    text = out.getvalue()
    assert "gpt2s_T1024_B16_flash: 3 steps traced, step 2.00 ms (device busy 1.60 ms)" in text
    assert "| matmul | 1.00 | 62.5 | 6 |" in text
    assert "700.00 W" in text


def test_capture_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        profile_step.main(["--device", "cpu", "--model", "resnet_micro", "--batch-size", "2",
                           "--image-size", "16", "--num-classes", "10", "--warmup", "1",
                           "--trace-steps", "1", "--top", "3", "--out", str(tmp_path / "p")])
    art = json.loads((tmp_path / "p.json").read_text())
    assert JAX_KEYS <= set(art)
    assert art["device"]["type"] == "cpu" and art["label"] == "resnet_micro_b2"
    assert art["categories"]["convolution"]["time_ps"] > 0
    assert (tmp_path / "p_trace" / "trace.json").exists()
    assert "| category | ms/step |" in out.getvalue()
