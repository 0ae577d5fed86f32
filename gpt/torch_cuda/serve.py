"""Continuous-batching serving CLI for checkpoints of
``gpt/torch_cuda/train.py``: the port of ``gpt/jax_tpu/serve.py``.

It reads one prompt per line (stdin, or ``--prompts-file``), serves them
all through the port's engine (``distributed_training_tpu_torch/
serving/``: up to ``--max-batch`` sequences decode together and freed
slots refill mid-flight), and prints the completions in submission order
and an SLA summary (TTFT/TPOT percentiles, throughput, queue depth), or
with ``--json`` the stats as one JSON line. SIGTERM closes admission
(later prompts are rejected with the typed ``DrainingError``) and drains
what was accepted; ``--flight-dump`` and ``--ledger-out`` are written
either way. This script imports nothing of the JAX package.

The model flags must match the training run so the checkpoint restores
(``inference/restore.py``, as ``generate.py``); I/O is byte-level (the
vocabulary of 256 is one token a byte). It serves on the card unless
``--device cpu`` asks for the CPU; without a card it fails.

The flags are the JAX CLI's: the prefix cache (``--prefix-cache``),
speculative decoding (``--spec-k``, ``--spec-drafter``), int8 weights and
KV pages (``--quantize-weights``, ``--kv-dtype int8``), the write-ahead
journal (``--journal-dir``: a restart replays it, redelivers finished
results, resumes the unfinished and skips the prompt lines already
consumed) and the live hot swap (``--watch-ckpt-dir``: SIGHUP polls now,
SIGUSR1 rolls back), the live endpoints (``--metrics-port``: ``/metrics``,
``/healthz``, ``/vars``, ``/timeseries``, ``/alerts``) and the control
room (``--slo-rules``, ``--incident-dir``: one bundle a fired alert, which
``python -m distributed_training_tpu_torch.tools.incident_report``
renders).

    echo -e "The \\nOnce upon" | python gpt/torch_cuda/serve.py \\
        -c ./checkpoint --max-batch 8 --max-new-tokens 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Run as a script from this directory: the repo root holds the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="TransformerLM continuous-batching serving")
    parser.add_argument("--prompts-file", type=str, default=None,
                        help="one UTF-8 prompt per line; default: stdin")
    # Serving knobs (ServeConfig).
    parser.add_argument("--max-batch", type=int, default=8,
                        help="decode slots (sequences batched an iteration)")
    parser.add_argument("--max-len", type=int, default=None,
                        help="per-slot KV tokens (prompt + output); "
                             "default: the model's --model-max-len table")
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy")
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--eos-id", type=int, default=None)
    parser.add_argument("--kv-page-size", type=int, default=8,
                        help="paged KV cache: a pool of pages of this many "
                             "tokens with a page table a slot; 0 = the "
                             "legacy contiguous slot per sequence")
    parser.add_argument("--kv-pages", type=int, default=None,
                        help="pool size in pages; default max_batch x "
                             "ceil(budget / page size); fewer oversubscribe")
    parser.add_argument("--prefill-chunk", type=int, default=64,
                        help="paged mode: prompt tokens prefilled per "
                             "iteration, in the decode step")
    parser.add_argument("--prefill-bucket", type=int, default=64,
                        help="legacy mode: prompts pad to a multiple of this")
    parser.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="radix-tree prefix cache: a prompt that starts with "
                             "a resident page-aligned prefix aliases its pages "
                             "and prefills only the tail (paged mode)")
    parser.add_argument("--prefix-cache-pages", type=int, default=None,
                        help="the prefix cache's page cap")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative decoding: drafts a slot verified in "
                             "one [max_batch, k+1] window; 0 = off")
    parser.add_argument("--spec-drafter", type=str, default="ngram",
                        choices=["ngram", "gpt"],
                        help="ngram = prompt lookup; gpt = self-drafting "
                             "with the serving weights")
    parser.add_argument("--spec-ngram", type=int, default=3,
                        help="longest suffix n-gram the ngram drafter matches")
    parser.add_argument("--spec-draft-window", type=int, default=16,
                        help="the gpt drafter's token window")
    parser.add_argument("--quantize-weights", action="store_true", default=False,
                        help="per-channel int8 matmul weights (and token "
                             "table), dequantized at use")
    parser.add_argument("--kv-dtype", type=str, default=None, choices=["int8"],
                        help="int8 KV pages with per-row scales (paged mode)")
    # SLO tiers and tenants.
    parser.add_argument("--num-tiers", type=int, default=1,
                        help="SLO tiers: priority 0 = highest; larger tiers "
                             "are shed and preempted first")
    parser.add_argument("--priority", type=int, default=0,
                        help="SLO tier of this CLI's prompts")
    parser.add_argument("--tenant", type=str, default="default",
                        help="tenant of this CLI's prompts")
    parser.add_argument("--tenant-quota", type=int, default=None,
                        help="max seated requests a tenant (None = uncapped)")
    parser.add_argument("--tier-reserved-slots", type=int, default=0,
                        help="slots held back from non-top tiers")
    parser.add_argument("--tier-reserved-pages", type=int, default=0,
                        help="pool pages held back from non-top tiers")
    parser.add_argument("--no-preempt", action="store_true", default=False,
                        help="no preempt-and-requeue of lower tiers")
    # Graceful degradation.
    parser.add_argument("--max-queue-depth", type=int, default=None,
                        help="bounded queue: past it the newest lower-tier "
                             "request is shed, else the incoming one "
                             "(QueueFullError)")
    parser.add_argument("--ttft-deadline-ms", type=float, default=None,
                        help="evict requests without a first token past this")
    parser.add_argument("--deadline-ms", type=float, default=None,
                        help="evict requests still decoding past this "
                             "(partial tokens returned)")
    parser.add_argument("--watch-ckpt-dir", type=str, default=None,
                        help="live weight hot swap: watch this checkpoint "
                             "directory and install each newly committed, "
                             "verified epoch at an iteration boundary. SIGHUP "
                             "polls now; SIGUSR1 re-arms the previous weights")
    parser.add_argument("--watch-interval", type=float, default=2.0,
                        help="seconds between the watcher's polls")
    parser.add_argument("--journal-dir", type=str, default=None,
                        help="write-ahead request journal: accepted requests "
                             "survive a crash; a restart redelivers finished "
                             "results and resumes the rest")
    parser.add_argument("--journal-fsync", type=str, default="batch",
                        choices=["none", "batch", "always"])
    parser.add_argument("--journal-segment-bytes", type=int, default=1 << 20)
    parser.add_argument("--flight-dump", type=str, default=None,
                        help="write a flight-recorder JSON here at exit "
                             "(the flight_report tools render it)")
    parser.add_argument("--ledger-out", type=str, default=None,
                        help="write each completed request's latency ledger "
                             "(serving/ledger.py) as one strict-JSON list")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="live telemetry: /metrics (Prometheus text), "
                             "/healthz, /vars, /timeseries and /alerts "
                             "while the engine serves (loopback; 0 = a "
                             "free port)")
    parser.add_argument("--slo-rules", type=str, default=None,
                        help="SLO burn-rate alerting: 'default' or "
                             "';'-separated name:metric[/den]>objective"
                             "[@fast,slow][xBURN][~CLEAR] clauses "
                             "(serving/alerts.py), evaluated every "
                             "--sample-every iterations")
    parser.add_argument("--incident-dir", type=str, default=None,
                        help="one incident bundle a fired alert, written "
                             "off the serving loop; needs --slo-rules")
    parser.add_argument("--sample-every", type=int, default=16,
                        help="time-series sample cadence in iterations")
    parser.add_argument("--trace", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="span trace: a track a decode slot with each "
                             "request's queued/prefill/decode spans")
    parser.add_argument("--trace-dir", type=str, default="./trace",
                        help="trace output directory")
    parser.add_argument("--json", action="store_true", default=False,
                        help="emit the SLA stats as one JSON line")
    # Model flags (mirror training; generate.py's contract).
    parser.add_argument("--vocab-size", type=int, default=256)
    parser.add_argument("--num-layers", type=int, default=4)
    parser.add_argument("--num-heads", type=int, default=4)
    parser.add_argument("--hidden-dim", type=int, default=256)
    parser.add_argument("--model-max-len", type=int, default=2048,
                        help="positional-table length used at training")
    parser.add_argument("--dtype", type=str, default="fp32",
                        choices=["bf16", "fp16", "fp32"])
    parser.add_argument("--head-bias", action=argparse.BooleanOptionalAction,
                        default=False)
    parser.add_argument("--logits-dtype", type=str, default="bf16",
                        choices=["fp32", "bf16"])
    parser.add_argument("--moe", action="store_true", default=False)
    parser.add_argument("--num-experts", type=int, nargs="+", default=[8])
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--min-capacity", type=int, default=0)
    parser.add_argument("--mlp-type", type=str, default="standard",
                        choices=["standard", "residual"])
    parser.add_argument("-c", "--checkpoint", type=str, default="./checkpoint")
    parser.add_argument("-r", "--resume", type=int, default=-1,
                        help="epoch to load; -1 = latest (random init if "
                             "no checkpoint exists)")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="must mirror training (restore template)")
    parser.add_argument("--use-ema", action="store_true", default=False,
                        help="serve the EMA parameter average")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cpu to serve on the CPU; default the card "
                             "(without one this fails)")
    return parser


def decode_bytes(toks) -> str:
    return bytes(int(t) % 256 for t in toks).decode("utf-8", errors="replace")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from distributed_training_tpu_torch.config import ServeConfig
    from distributed_training_tpu_torch.inference.restore import (
        build_lm_and_restorer,
        moe_kwargs_from_flags,
    )
    from distributed_training_tpu_torch.inference.sampler import CacheBudgetError
    from distributed_training_tpu_torch.observability.exporter import attach_engine
    from distributed_training_tpu_torch.observability.trace import session_for_cli
    from distributed_training_tpu_torch.runtime.preemption import PreemptionGuard
    from distributed_training_tpu_torch.serving import (
        DrainingError,
        Engine,
        HotSwapper,
        QueueFullError,
    )
    from distributed_training_tpu_torch.serving.ledger import dump_ledgers

    def log(msg: str) -> None:
        print(f"[serve] {msg}", file=sys.stderr, flush=True)

    model, restored_epoch, restore_fn = build_lm_and_restorer(
        vocab_size=args.vocab_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        hidden_dim=args.hidden_dim,
        max_len=args.model_max_len,
        dtype=args.dtype,
        head_bias=args.head_bias,
        logits_dtype=args.logits_dtype,
        moe_kwargs=moe_kwargs_from_flags(
            enabled=args.moe, num_experts=args.num_experts,
            top_k=args.moe_top_k, min_capacity=args.min_capacity,
            mlp_type=args.mlp_type),
        checkpoint=args.checkpoint,
        resume=args.resume,
        ema_decay=args.ema_decay,
        use_ema=args.use_ema,
        seed=args.seed,
        device=args.device,
        printer=log,
    )
    trace, trace_path = session_for_cli(args.trace, args.trace_dir, "serve")
    engine = Engine(model, ServeConfig(
        max_batch=args.max_batch,
        max_len=args.max_len,
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        eos_id=args.eos_id,
        kv_page_size=args.kv_page_size or None,
        kv_pages=args.kv_pages,
        prefill_chunk=args.prefill_chunk,
        prefill_bucket=args.prefill_bucket,
        prefix_cache=args.prefix_cache,
        prefix_cache_pages=args.prefix_cache_pages,
        spec_k=args.spec_k,
        spec_drafter=args.spec_drafter,
        spec_ngram=args.spec_ngram,
        spec_draft_window=args.spec_draft_window,
        quantize_weights=args.quantize_weights,
        kv_dtype=args.kv_dtype,
        num_tiers=args.num_tiers,
        tenant_quota=args.tenant_quota,
        tier_reserved_slots=args.tier_reserved_slots,
        tier_reserved_pages=args.tier_reserved_pages,
        preempt=not args.no_preempt,
        max_queue_depth=args.max_queue_depth,
        ttft_deadline_ms=args.ttft_deadline_ms,
        deadline_ms=args.deadline_ms,
        journal_dir=args.journal_dir,
        journal_fsync=args.journal_fsync,
        journal_segment_bytes=args.journal_segment_bytes,
        sample_every=args.sample_every,
        slo_rules=args.slo_rules,
        incident_dir=args.incident_dir,
        seed=args.seed,
    ), trace=trace, weights_epoch=restored_epoch)

    # The live hot swap: a watcher thread streams newly committed epochs
    # of --watch-ckpt-dir through verification into the engine. The
    # signal handlers only set events: the rollback takes the engine's
    # swap lock, which this thread holds around the barrier.
    swapper = None
    if args.watch_ckpt_dir is not None:
        import signal as signal_mod

        watch_dir = args.watch_ckpt_dir
        swapper = HotSwapper(engine, watch_dir, lambda e: restore_fn(e, watch_dir),
                             printer=lambda msg: print(msg, file=sys.stderr, flush=True))
        swapper.start(interval_s=args.watch_interval)
        if hasattr(signal_mod, "SIGHUP"):
            signal_mod.signal(signal_mod.SIGHUP, lambda *_: swapper.trigger())
        if hasattr(signal_mod, "SIGUSR1"):
            signal_mod.signal(signal_mod.SIGUSR1, lambda *_: swapper.request_rollback())
        log(f"hot-swap watcher on {watch_dir} (every {args.watch_interval:g}s; "
            f"SIGHUP = poll now, SIGUSR1 = rollback)")

    # The live endpoints read host state the loop already holds
    # (flight_snapshot never flushes or reads the card); up before the
    # replay, so /healthz reads 'recovering' while it runs.
    exporter = None
    if args.metrics_port is not None:
        exporter = attach_engine(engine, args.metrics_port, component="serve",
                                 printer=log)

    # The journal's replay comes before the prompt stream: finished but
    # unacked results are redelivered once, unfinished requests re-seat,
    # and the journaled line cursor skips prompts an earlier life took.
    report = engine.recover()
    recovered = report["redelivered"] + report["completed_at_replay"]
    lines_consumed = int(report["notes"].get("lines_consumed", 0))
    if recovered or report["resumed"] or lines_consumed:
        log(f"journal recovery: {len(recovered)} redelivered/expired, "
            f"{report['resumed']} resumed; skipping {lines_consumed} "
            f"already-consumed prompt line(s)")

    if args.prompts_file:
        with open(args.prompts_file) as fh:
            lines = [ln.rstrip("\n") for ln in fh]
    else:
        lines = [ln.rstrip("\n") for ln in sys.stdin]
    lines = [ln for ln in lines if ln]
    if not lines and not (recovered or report["resumed"]):
        raise SystemExit("no prompts (stdin/--prompts-file was empty)")
    lines = lines[lines_consumed:]

    # Graceful drain: SIGTERM latches; the submit loop then closes
    # admission (later prompts get the typed DrainingError) and the engine
    # completes what it accepted before the reports are written. A second
    # SIGTERM goes to the previous handler.
    texts: dict[int, str] = {}
    with PreemptionGuard() as guard:
        log("engine ready")
        for text in lines:
            if guard.triggered:
                engine.close_admission()
            if engine.journal is not None:
                # The line cursor is journaled before the line is acted
                # on (at most once); the admit below persists it in the
                # same batch.
                lines_consumed += 1
                engine.journal.log_note({"lines_consumed": lines_consumed}, flush=False)
            tokens = np.frombuffer(text.encode("utf-8"), np.uint8)
            if (tokens >= args.vocab_size).any():
                log(f"SKIP (bytes outside vocab {args.vocab_size}): {text!r}")
                continue
            try:
                req = engine.submit(tokens.astype(np.int32), priority=args.priority,
                                    tenant=args.tenant)
            except DrainingError as e:
                log(f"DRAINING, reject {text!r}: {e}")
                continue
            except (CacheBudgetError, QueueFullError) as e:
                log(f"REJECT {text!r}: {e}")
                continue
            texts[req.uid] = text
        # One-shot CLI: ending through drain() makes the normal path and
        # the SIGTERM path the same (close admission, finish, report). The
        # journal's recoveries are this process's deliveries too.
        done = recovered + engine.drain()
        if guard.triggered:
            log(f"SIGTERM: drained {len(done)} in-flight request(s), admission closed")
    if swapper is not None:
        swapper.close()
        log(f"hot-swap: {swapper.counters['armed']} armed / "
            f"{swapper.counters['rejected']} rejected over {swapper.counters['polls']} "
            f"polls; serving weights epoch {engine.weights_epoch}")

    for fin in sorted(done, key=lambda f: f.uid):
        ttft = "-" if fin.ttft_ms is None else f"{fin.ttft_ms:.1f} ms"
        text = texts.get(fin.uid, decode_bytes(fin.prompt))
        print(f"[serve] #{fin.uid} ({fin.finish_reason}, ttft {ttft}): "
              f"{text!r} -> {decode_bytes(fin.tokens)!r}")

    if engine.journal is not None:
        # The client cursor: the completions above are consumed, so a
        # later recovery does not redeliver them.
        engine.journal.ack([f.uid for f in done])
        engine.journal.shutdown()

    stats = engine.stats()
    if args.json:
        print(json.dumps(stats, allow_nan=False))
    else:
        log(f"{stats['requests_finished']} requests, "
            f"{stats['tokens_emitted']} tokens, "
            f"{stats['throughput_tok_s']:.1f} tok/s | "
            f"ttft p50 {stats['ttft_p50_ms']:.1f} / p95 {stats['ttft_p95_ms']:.1f} ms | "
            f"tpot p50 {stats['tpot_p50_ms']:.2f} / p95 {stats['tpot_p95_ms']:.2f} ms | "
            f"queue depth max {stats['queue_depth_max']}")
        if args.slo_rules:
            log(f"alerts: {stats['alerts_fired']} fired, "
                f"{stats['alerts_cleared']} cleared, "
                f"{stats['alerts_active']} active | "
                f"incidents {stats['incidents_captured']}")
    if args.ledger_out:
        n_rows, bad = dump_ledgers(args.ledger_out, done)
        log(f"latency ledgers: {args.ledger_out} ({n_rows} requests, "
            f"{bad} conservation violation(s))")
    if args.flight_dump:
        engine.dump_flight(args.flight_dump)
        log(f"flight record: {args.flight_dump}")
    # Every captured bundle on disk before exit (as journal.shutdown).
    engine.close_incidents()
    if engine.incidents is not None:
        log(f"incidents: {args.incident_dir} ({engine.incidents.captured} captured, "
            f"{engine.incidents.write_errors} write error(s))")
    if trace is not None:
        trace.save(trace_path)
        log(f"trace: {trace_path} ({len(trace)} events)")
    if exporter is not None:
        exporter.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
