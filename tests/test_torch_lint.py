"""The port lints clean under the repo's own linter, every rule on.

``tests/test_lint.py`` holds the JAX package at zero findings; this file
holds the PyTorch port, its GPT CLI and its ResNet CLI there too.
"""

import os

import pytest

from tools.lint import run_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_TREES = ["distributed_training_tpu_torch", "gpt/torch_cuda",
              "resnet/torch_cuda"]


def test_port_lints_clean(monkeypatch):
    monkeypatch.chdir(REPO)
    findings, summary = run_lint(PORT_TREES)
    assert findings == [], [f.render() for f in findings]
    assert summary["files"] > 0


@pytest.mark.parametrize("tree", PORT_TREES)
def test_each_port_tree_lints_clean(monkeypatch, tree):
    # One tree at a time: the cross-file rules resolve names within what
    # they are given, so a tree linted alone must be clean as well.
    monkeypatch.chdir(REPO)
    findings, _ = run_lint([tree])
    assert findings == [], [f.render() for f in findings]
