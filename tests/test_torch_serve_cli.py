"""``gpt/torch_cuda/serve.py``, the port of ``gpt/jax_tpu/serve.py``, on
the CPU (``--device cpu``) over a checkpoint the port's GPT CLI wrote:
the completions in submission order (greedy, each equal to the port's
``Generator`` on the restored model), ``--json``, ``--ledger-out``,
``--flight-dump`` through the port's ``flight_report``, the SIGTERM
drain in a subprocess, the serving features' and the control room's
flags (``--slo-rules``, ``--incident-dir``, ``--metrics-port``), and no
CPU fallback without ``--device cpu``.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.inference import Generator, SampleConfig
from distributed_training_tpu_torch.inference import restore as restore_lib
from distributed_training_tpu_torch.tools import flight_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = os.path.join(ROOT, "gpt", "torch_cuda", "serve.py")
MODEL = ["--num-layers", "1", "--num-heads", "2", "--hidden-dim", "16",
         "--model-max-len", "64"]
PROMPTS = ["ab", "cdef", "", "xy"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One epoch of the port's GPT CLI at the serve flags' model."""
    d = tmp_path_factory.mktemp("serve_ck")
    cli = _load(os.path.join(ROOT, "gpt", "torch_cuda", "train.py"), "port_gpt_cli_serve")
    cli.main(["--device", "cpu", "-e", "1", "--steps-per-epoch", "2", "-b", "2",
              "--seq-len", "8", "--num-layers", "1", "--num-heads", "2", "--hidden-dim", "16",
              "--max-len", "64", "--log-interval", "1", "-i", "1", "--no-flight-recorder",
              "-c", str(d / "ck")])
    return str(d / "ck")


@pytest.fixture(scope="module")
def serve_cli():
    return _load(SERVE, "port_serve_cli")


@pytest.fixture(scope="module")
def served(ckpt, serve_cli, tmp_path_factory):
    d = tmp_path_factory.mktemp("served")
    pfile = d / "prompts.txt"
    pfile.write_text("".join(p + "\n" for p in PROMPTS))
    out = {"ledger": str(d / "ledger.json"), "flight": str(d / "flight.json")}
    import contextlib
    import io

    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        rc = serve_cli.main(["--device", "cpu", "-c", ckpt, "--prompts-file", str(pfile),
                             *MODEL, "--max-new-tokens", "5", "--max-batch", "2",
                             "--prefill-chunk", "4", "--json",
                             "--ledger-out", out["ledger"], "--flight-dump", out["flight"]])
    out.update(rc=rc, stdout=stdout.getvalue(), stderr=stderr.getvalue())
    return out


def test_completions_in_submission_order_equal_the_generator(served, ckpt):
    assert served["rc"] == 0
    assert "restored epoch 0" in served["stderr"]
    lines = [ln for ln in served["stdout"].splitlines() if ln.startswith("[serve] #")]
    assert [ln.split()[1] for ln in lines] == ["#0", "#1", "#2"]
    model, _ = restore_lib.build_lm_and_restore(
        vocab_size=256, num_layers=1, num_heads=2, hidden_dim=16, max_len=64,
        checkpoint=ckpt, device="cpu", printer=lambda m: None)
    gen = Generator(model, SampleConfig(max_new_tokens=5, temperature=0.0))
    for ln, text in zip(lines, [p for p in PROMPTS if p]):
        want = gen(np.frombuffer(text.encode(), np.uint8).astype(np.int64))[0]
        completion = bytes(int(t) % 256 for t in want).decode("utf-8", errors="replace")
        assert ln.endswith(f"{text!r} -> {completion!r}"), ln


def test_json_line_is_the_stats(served):
    stats = json.loads([ln for ln in served["stdout"].splitlines() if ln.strip()][-1])
    assert stats["requests_finished"] == 3 and stats["tokens_emitted"] == 15
    assert stats["drained"] is True and stats["throughput_tok_s"] > 0
    assert stats["alerts_fired"] == 0 and stats["ledger_conservation_violations"] == 0


def test_ledger_out_and_flight_dump(served):
    rows = json.load(open(served["ledger"]))
    assert [r["uid"] for r in rows] == [0, 1, 2]
    assert all(r["ledger"]["conserved"] for r in rows)
    snap = json.load(open(served["flight"]))
    text = flight_report.render(flight_report.summarize(snap))
    assert "serving: 3 requests" in text and "latency ledger" in text


def test_sigterm_drains_and_writes_a_valid_dump(ckpt, tmp_path):
    pfile = tmp_path / "prompts.txt"
    pfile.write_text("".join(f"prompt {i}\n" for i in range(48)))
    dump = tmp_path / "drain_flight.json"
    err_path = tmp_path / "serve.stderr"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    with open(err_path, "w") as errfh:
        proc = subprocess.Popen(
            [sys.executable, SERVE, "--device", "cpu", "-c", ckpt,
             "--prompts-file", str(pfile), *MODEL, "--max-new-tokens", "48",
             "--max-batch", "2", "--json", "--flight-dump", str(dump)],
            stdout=subprocess.PIPE, stderr=errfh, text=True, env=env)
        deadline = time.time() + 120
        while "engine ready" not in open(err_path).read():
            assert proc.poll() is None, open(err_path).read()[-2000:]
            assert time.time() < deadline, "serve.py never reported ready"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    err = open(err_path).read()
    assert proc.returncode == 0, err[-2000:]
    assert "SIGTERM: drained" in err
    stats = json.loads([ln for ln in out.splitlines() if ln.strip()][-1])
    assert stats["drained"] is True
    assert stats["requests_finished"] + stats["requests_drain_rejected"] == 48
    snap = json.load(open(dump))
    assert snap["serving"]["drained"] is True


PORTED = [["--prefix-cache"], ["--spec-k", "2"], ["--quantize-weights"],
          ["--kv-dtype", "int8"], ["--journal-dir", "{tmp}/j"], ["--watch-ckpt-dir", "{ckpt}"],
          ["--slo-rules", "default", "--flight-dump", "{tmp}/f.json"],
          ["--incident-dir", "{tmp}/inc", "--slo-rules", "queued:queue_depth>0.5@1,1",
           "--sample-every", "1"],
          ["--metrics-port", "0"]]


@pytest.mark.parametrize("flag", PORTED, ids=[f[0] for f in PORTED])
def test_ported_flag_runs(serve_cli, ckpt, served, flag, tmp_path):
    """Each serving flag runs the CLI to the end over the same prompts:
    the prefix cache, speculation, the journal, the watcher (with nothing
    newer to install) and the control room's flags print the plain run's
    completions; a second run over the same journal skips the lines it
    consumed and redelivers nothing it acked; the default SLO rules stand
    in the flight dump and fire nothing; a rule over the queue writes its
    incident bundle; ``--metrics-port`` serves while the CLI runs."""
    import contextlib
    import io

    pfile = tmp_path / "prompts.txt"
    pfile.write_text("".join(p + "\n" for p in PROMPTS))
    argv = ["--device", "cpu", "-c", ckpt, "--prompts-file", str(pfile), *MODEL,
            "--max-new-tokens", "5", "--max-batch", "2", "--prefill-chunk", "4", "--json",
            *(f.format(tmp=tmp_path, ckpt=ckpt) for f in flag)]

    def run():
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = serve_cli.main(argv)
        return rc, out.getvalue(), err.getvalue()

    rc, out, err = run()
    assert rc == 0, err[-2000:]
    stats = json.loads(out.splitlines()[-1])
    assert stats["requests_finished"] == 3
    lines = [ln for ln in out.splitlines() if ln.startswith("[serve] #")]
    if flag[0] in ("--prefix-cache", "--spec-k", "--journal-dir", "--watch-ckpt-dir",
                   "--slo-rules", "--incident-dir", "--metrics-port"):
        want = [ln for ln in served["stdout"].splitlines() if ln.startswith("[serve] #")]
        strip = [ln.split(" (")[0] + ln.split("):", 1)[1] for ln in lines]
        assert strip == [ln.split(" (")[0] + ln.split("):", 1)[1] for ln in want]
    if flag[0] == "--journal-dir":
        assert stats["journal_records_written"] > 0
        rc, out, err = run()
        assert rc == 0 and "skipping 3 already-consumed" in err
        assert json.loads(out.splitlines()[-1])["requests_finished"] == 0
    if flag[0] == "--watch-ckpt-dir":
        assert "hot-swap: 0 armed / 0 rejected" in err
    if flag[0] == "--quantize-weights":
        assert stats["quantized_params_bytes"] > 0 and stats["weight_quant_s"] > 0
    if flag[0] == "--slo-rules":
        dump = json.load(open(tmp_path / "f.json"))
        assert len(dump["alerts"]["rules"]) == 7 and stats["alerts_fired"] == 0
    if flag[0] == "--incident-dir":
        assert stats["alerts_fired"] == stats["incidents_captured"] == 1
        assert os.listdir(tmp_path / "inc") == ["incident_000_queued.json"]
        assert "incidents: " in err and "(1 captured, 0 write error(s))" in err
    if flag[0] == "--metrics-port":
        assert "[serve] live metrics: http://127.0.0.1:" in err


def test_no_cpu_fallback_without_a_card(serve_cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["-c", str(tmp_path / "none"), *MODEL])
