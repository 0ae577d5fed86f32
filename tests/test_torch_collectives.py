"""The port's collective accounting (``utils/collectives.py``,
``tools/collective_accounting.py``) against the JAX package's.

One spawn of four gloo ranks (``tests/torch_dist_worker.py``, torch and
the port only) serves the module: the counter on a group of two ranks,
every row of the tool over the four ranks, then, on rank 0 alone in a
gloo group of one rank, ``chip_smoke.expected_dp_collectives`` against
one counted step of the DP presets and the GPT CLI at micro width. The
rows are held to the wire invariants of ``tests/test_collectives.py`` and
their gradient bytes to JAX's models built here; the committed
``profiles/torch_collectives_8rank.json`` to JAX's
``profiles/collectives_8dev.json``, and the tool's 8-rank CPU run must
reproduce it exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from distributed_training_tpu_torch.tools import collective_accounting as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILES = os.path.join(REPO, "profiles")
LAYERS = tool.LM_KW["num_layers"]
# The GPT CLI's ZeRO 2 run of chip_smoke.py's gpt_cli phase at micro width.
GPT_ARGV = ["--vocab-size", "64", "--num-layers", "2", "--num-heads", "2", "--hidden-dim",
            "32", "--seq-len", "32", "--max-len", "32", "-b", "2", "--dtype", "bf16",
            "--attn-impl", "flash", "--no-head-bias", "-e", "1", "--steps-per-epoch", "1",
            "--stage", "2", "--remat", "--ce-chunk-size", "16", "--device", "cpu"]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives")
    torch.save({"dir": str(out), "gpt_argv": GPT_ARGV}, out / "job.pt")
    results = worker.spawn(out, 4, ("_collective_counter", "_accounting_rows",
                                    "_world1_expectation"))()
    return {"counter": results[0]["counter"], "rows": results[0]["rows"],
            "world1": results[0]["world1"], "counter_1": results[1]["counter"]}


def _jax_param_bytes() -> dict:
    """4 × the parameter count of each row's model, built in JAX as
    ``tools/collective_accounting.py`` (the root's) builds it (shapes only)."""
    import jax
    import jax.numpy as jnp

    from distributed_training_tpu.models import get_model

    def count(name, shape, dtype, **kw):
        model = get_model(name, **kw)
        shapes = jax.eval_shape(
            lambda k: model.init({"params": k, "dropout": k}, jnp.zeros(shape, dtype),
                                 train=False), jax.random.PRNGKey(0))
        return 4 * sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))

    lm = dict(num_classes=tool.VOCAB, seq_axis=None, num_layers=2, num_heads=2,
              hidden_dim=16, max_len=64)
    moe = dict(moe_num_experts=4, moe_top_k=1, moe_expert_axis="expert")
    image = count("resnet_micro", (2, 8, 8, 3), jnp.float32, num_classes=10, stem="cifar")
    vit = count("vit_b16", (2, 8, 8, 3), jnp.float32, num_classes=10, patch_size=4,
                hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64)
    dense = count("transformer_lm", (2, 8), jnp.int32, **lm)
    out = {}
    for name in _jax_rows():
        if name.startswith("image vit"):
            out[name] = vit
        elif name.startswith("image"):
            out[name] = image
        elif "circular" in name:
            out[name] = count("transformer_lm", (2, 8), jnp.int32, **{**lm, "num_layers": 4})
        elif "moe stages" in name:
            out[name] = count("transformer_lm", (2, 8), jnp.int32, moe_every=1, **lm, **moe)
        elif "ep" in name:
            out[name] = count("transformer_lm", (2, 8), jnp.int32, **lm, **moe)
        else:
            out[name] = dense
    return out


def _jax_rows() -> dict:
    with open(os.path.join(PROFILES, "collectives_8dev.json")) as fh:
        return json.load(fh)["strategies"]


def _committed() -> dict:
    with open(os.path.join(PROFILES, "torch_collectives_8rank.json")) as fh:
        return json.load(fh)


def test_counter_counts_each_call_once_with_its_output_bytes(spawned):
    """Every counted function once with known shapes (the analogue of
    ``test_parser_handles_tuple_and_async_forms``): all-reduce 3×5 and 2
    float32, all-gather of 2×4 and into 12 float32, a reduce-scatter
    returning 3 float64, a broadcast of 7 int32, and a batch of two sends
    and two receives (2 float32, 3 int64) as two permutes; an async call
    counts when issued; a call made inside a counted call counts once; the
    functions are back after the block, and after an exception in it."""
    for c in (spawned["counter"], spawned["counter_1"]):
        assert c["calls"] == {
            "all-reduce": {"count": 2, "bytes": 15 * 4 + 2 * 4},
            "all-gather": {"count": 2, "bytes": 2 * 4 * 4 + 12 * 4},
            "reduce-scatter": {"count": 1, "bytes": 3 * 8},
            "collective-broadcast": {"count": 1, "bytes": 7 * 4},
            "collective-permute": {"count": 2, "bytes": 2 * 4 + 3 * 8}}
        assert c["before_async"]["all-reduce"] == {"count": 1, "bytes": 60}
        assert c["issued"] == {"count": 2, "bytes": 68}
        assert c["received"] == [[1.0, 1.0], [1, 1, 1]]
        assert c["nested"] == {"all-gather": {"count": 1, "bytes": 16}}
        assert c["restored"] and c["restored_after_raise"]


def test_counter_loses_no_call_across_threads(monkeypatch):
    """Autograd runs a CUDA backward's collectives on its own thread: the
    counter's totals are shared. 16 threads (more than the cores) each
    call a counted function 500 times, switching every microsecond; no
    call is lost, and each thread's depth guard is its own."""
    import sys
    import threading

    import torch.distributed as dist

    from distributed_training_tpu_torch.utils.collectives import count_collectives

    monkeypatch.setattr(dist, "all_reduce", lambda tensor, **kw: None)
    t, threads = torch.ones(3), 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with count_collectives() as acct:
            workers = [threading.Thread(target=lambda: [dist.all_reduce(t)
                                                        for _ in range(500)])
                       for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert acct == {"all-reduce": {"count": threads * 500, "bytes": threads * 500 * 12}}


def test_rows_cover_jax_and_match_its_gradient_bytes(spawned):
    """The tool's rows at 4 ranks: JAX's names, each row's
    ``grad_bytes_fp32`` equal to 4 × the parameter count of the same model
    built in JAX, and the mesh shapes of the 4-rank forms."""
    rows, jax_bytes = spawned["rows"], _jax_param_bytes()
    assert set(rows) == set(_jax_rows())
    for name, row in rows.items():
        assert row["grad_bytes_fp32"] == jax_bytes[name], name
        assert row["collectives"], name
    assert rows["image dp (zero-0)"]["mesh"] == {"data": 4}
    assert rows["lm dp×sp×tp"]["mesh"] == {"sequence": 2, "model": 2}


def test_rows_hold_the_wire_invariants(spawned):
    """``tests/test_collectives.py``'s invariants on the port's live rows:
    DP's all-reduce covers the gradient bytes without ballooning, with no
    gather or permute; ZeRO 3 gathers; the ring permutes exactly
    4·(n−1)·layers times (``ring_attention.py``: n−1 shifts of K and V a
    layer forward, of dK and dV backward; n = 2), its all-reduce covers
    the gradients; SP ZeRO 1 gathers; TP all-reduces at least twice a
    layer; tp-overlap permutes at least 4× a layer and all-reduces fewer
    bytes than plain TP, with no reduce-scatter; the pipeline permutes."""
    rows = {n: r["collectives"] for n, r in spawned["rows"].items()}
    g = spawned["rows"]["image dp (zero-0)"]["grad_bytes_fp32"]
    dp = rows["image dp (zero-0)"]
    assert g <= dp["all-reduce"]["bytes"] < 2 * g
    assert "all-gather" not in dp and "collective-permute" not in dp
    assert rows["image dp zero-3"]["all-gather"]["bytes"] > 0
    sp = rows["lm dp×sp (ring)"]
    assert sp["collective-permute"]["count"] == 4 * (2 - 1) * LAYERS
    g_lm = spawned["rows"]["lm dp×sp (ring)"]["grad_bytes_fp32"]
    assert g_lm <= sp["all-reduce"]["bytes"] < 2 * g_lm
    assert "all-gather" not in sp
    assert rows["lm dp×sp zero-1"]["all-gather"]["bytes"] > 0
    tp, overlap = rows["lm dp×tp zero-1"], rows["lm dp×tp overlap"]
    assert tp["all-reduce"]["count"] >= 2 * LAYERS
    assert "collective-permute" not in tp
    assert overlap["collective-permute"]["count"] >= 4 * LAYERS
    assert overlap["all-reduce"]["bytes"] < tp["all-reduce"]["bytes"]
    assert "reduce-scatter" not in overlap
    assert rows["lm dp×pp (gpipe)"]["collective-permute"]["count"] >= 2


def test_committed_8rank_artifact(spawned):
    """``profiles/torch_collectives_8rank.json``: 8 gloo ranks, JAX's rows
    with JAX's gradient bytes, and the kind invariants of
    ``test_committed_artifact_covers_all_strategies`` where the semantics
    agree. Two differ by design: the ring's dp×sp row all-reduces twice
    (the gradients, then the metrics, each one call; XLA's combiner fuses
    them into one op), and the circular pipeline issues more permutes than
    GPipe (dynamic counts: its ring wraps v times, where JAX's static count
    is equal)."""
    report, jax_rows = _committed(), _jax_rows()
    assert (report["devices"], report["platform"], report["backend"]) == (8, "cpu", "gloo")
    s = report["strategies"]
    assert set(s) == set(jax_rows)
    for name, row in s.items():
        assert row["grad_bytes_fp32"] == jax_rows[name]["grad_bytes_fp32"], name
        assert row["collectives"], name
    c = {n: r["collectives"] for n, r in s.items()}
    dp = s["image dp (zero-0)"]
    assert dp["collectives"]["all-reduce"]["bytes"] >= dp["grad_bytes_fp32"]
    assert "all-gather" not in c["image dp (zero-0)"]
    assert "all-gather" in c["image dp zero-3"]
    assert c["lm dp×sp (ring)"]["collective-permute"]["count"] >= 4
    ppe = c["lm dp×pp×ep zero-1 (moe stages)"]
    assert ppe["collective-permute"]["count"] >= 2 and "all-gather" in ppe
    assert (c["lm dp×pp×sp zero-1 (ring-in-stage)"]["collective-permute"]["count"]
            > c["lm dp×pp (gpipe)"]["collective-permute"]["count"])
    assert c["lm dp×sp (ring)"]["all-reduce"]["count"] == 2  # JAX: 1 (fused)
    assert "all-gather" not in c["lm dp×sp (ring)"]
    assert "all-gather" in c["lm dp×sp zero-1"]
    assert "all-gather" in c["lm dp×pp zero-1"]
    assert "collective-permute" in c["lm dp×pp zero-1"]
    assert "all-gather" not in c["lm dp×pp (gpipe)"]
    assert (c["lm dp×pp circular (v=2)"]["collective-permute"]["count"]  # JAX: equal
            > c["lm dp×pp (gpipe)"]["collective-permute"]["count"])
    assert c["image vit dp×tp zero-1"]["all-reduce"]["count"] > 2
    assert "all-gather" in c["image vit dp×tp zero-1"]
    for row in ("lm dp×tp overlap", "lm dp×sp×tp overlap", "image vit dp×tp overlap"):
        assert c[row]["collective-permute"]["count"] >= 8, row
        assert "reduce-scatter" not in c[row], row
    assert (c["lm dp×sp×tp overlap"]["collective-permute"]["count"]
            > c["lm dp×tp overlap"]["collective-permute"]["count"])
    assert "all-gather" not in c["image vit dp×tp overlap"]


def test_committed_4gpu_artifact(spawned):
    """``profiles/torch_collectives_4gpu.json`` (``chip_smoke.py --mesh
    collectives`` on four H100s): its micro rows over NCCL equal the same
    rows over four gloo ranks here, and its full-width steps hold the
    invariants the part checks: data parallelism's all-reduce in [G, 2G)
    bytes, ZeRO 3's all-gather, the sp, overlap and pipeline permutes."""
    with open(os.path.join(PROFILES, "torch_collectives_4gpu.json")) as fh:
        report = json.load(fh)
    assert (report["devices"], report["backend"]) == (4, "nccl")
    assert "H100" in report["card"]
    assert report["strategies"] == spawned["rows"]
    full = report["full_width"]
    for name in ("dp", "dp_zero1", "resnet18_dp4"):
        g = full[name]["grad_bytes_fp32"]
        assert g <= full[name]["collectives"]["all-reduce"]["bytes"] < 2 * g, name
        assert full[name]["collectives"] == full[name]["expected"], name
    assert "all-gather" in full["dp_zero3"]["collectives"]
    for name in ("sp4", "tp4_overlap", "tp2_sp2", "tp2_sp2_overlap", "pp4"):
        assert full[name]["collectives"]["collective-permute"]["count"] > 0, name


def test_the_8rank_cpu_run_reproduces_the_artifact(tmp_path):
    report = tool.main(["--device", "cpu", "--ranks", "8", "--out", str(tmp_path / "acct")])
    with open(tmp_path / "acct.json") as fh:
        assert json.load(fh) == _committed() == json.loads(json.dumps(report))


def test_cli_only_implies_merge_and_the_card_is_the_default(tmp_path, monkeypatch, capsys):
    """``--only`` rebuilds the matching rows into the existing file and keeps
    the others; without ``--device cpu`` and without enough cards the tool
    raises before it spawns a rank."""
    out = str(tmp_path / "acct")
    with open(out + ".json", "w") as fh:
        json.dump({"strategies": {"kept row": {"collectives": {}}}}, fh)
    calls = []

    def rows(world, device, only=None):
        calls.append((world, device, only))
        return {"image dp (zero-0)": {"collectives": {"all-reduce": {"count": 1}}}}

    monkeypatch.setattr(tool, "spawn_rows", rows)
    tool.main(["--device", "cpu", "--ranks", "4", "--only", "dp (zero-0)", "--out", out])
    assert "--only implies --merge" in capsys.readouterr().err
    assert calls == [(4, "cpu", "dp (zero-0)")]
    with open(out + ".json") as fh:
        assert set(json.load(fh)["strategies"]) == {"kept row", "image dp (zero-0)"}
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tool.main(["--ranks", str(torch.cuda.device_count() + 1), "--out", out])
    assert len(calls) == 1


@pytest.mark.parametrize("name", ["torch_ddp", "torch_ddp_fp16", "low_level_zero",
                                  "gemini", "deepspeed", "gpt_cli"])
def test_world1_expectation_of_chip_smoke(spawned, name):
    """``chip_smoke.expected_dp_collectives``, which the DP and gpt_cli
    phases hold one full-width step to on the card, against one counted
    step at micro width in a gloo group of one rank: counts and bytes."""
    run = spawned["world1"][name]
    assert run["world"] == 1
    assert run["got"] == run["want"]
    assert run["got"]["all-reduce"]["count"] >= 1


@pytest.mark.cuda
def test_counter_under_a_world1_nccl_group(tmp_path):
    """On the card: the counter under a world-1 NCCL group, and its refusal
    inside a CUDA graph capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs only on the card")
    import torch.distributed as dist

    from distributed_training_tpu_torch.runtime import distributed
    from distributed_training_tpu_torch.utils.collectives import count_collectives

    distributed.initialize_distributed(init_method=f"file://{tmp_path / 'store'}",
                                       world_size=1, rank=0)
    try:
        t = torch.ones(1000, device="cuda")
        with count_collectives() as acct:
            dist.all_reduce(t)
            dist.all_gather_into_tensor(torch.empty(1000, device="cuda"), t)
        assert acct == {"all-reduce": {"count": 1, "bytes": 4000},
                        "all-gather": {"count": 1, "bytes": 4000}}
        with count_collectives(), pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                dist.all_reduce(t)
    finally:
        distributed.shutdown_distributed()
