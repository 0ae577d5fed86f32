"""The kernel build's naming: one library per ``csrc/*.cu``, named by a hash
of that source and of every ``csrc/*.cuh`` header, so that an edited
header builds every source anew instead of loading a stale library."""

from distributed_training_tpu_torch.ops import cuda_build


def _csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "common.cuh").write_text("int c;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    return tmp_path


def test_kernel_names_list_sources_not_headers(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    assert cuda_build.kernel_names() == ["a", "b"]


def test_the_real_sources_and_their_headers():
    names = cuda_build.kernel_names()
    assert names == ["conv3x3_stats", "flash_attention", "flash_attention_split",
                     "fused_adam"]


def test_an_edited_header_or_source_renames_the_library(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = {n: cuda_build._target(n) for n in ("a", "b")}
    assert before == {n: cuda_build._target(n) for n in ("a", "b")}
    (csrc / "common.cuh").write_text("int c = 1;\n")
    after_header = {n: cuda_build._target(n) for n in ("a", "b")}
    assert all(after_header[n] != before[n] for n in ("a", "b"))
    (csrc / "b.cu").write_text("int b = 2;\n")
    assert cuda_build._target("b") != after_header["b"]
    assert cuda_build._target("a") == after_header["a"]
