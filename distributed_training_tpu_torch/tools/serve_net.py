"""Network serving launcher: N engine replicas behind the front door.

The port of the repo's ``tools/serve_net.py``, which imports the JAX
package. Two modes, one file:

- ``--replica``: ONE engine and its SSE frontend
  (``serving/frontend.py``) in this process on a free port. It prints
  ``{"replica": NAME, "port": N}`` as its first stdout line only after
  ``engine.recover()`` returned (so a journal's replay always precedes
  the port), and serves until its stdin closes or SIGTERM. It serves on
  the card unless ``--device cpu`` asks for the CPU; without a card it
  fails.
- front-door mode (the default): spawn ``--replicas N`` replica
  subprocesses under a :class:`ReplicaSupervisor` (same model seed, so
  the same weights everywhere and completions independent of routing),
  put them behind the cache-aware :class:`Router` and its
  :class:`RouterFrontDoor`, and either serve (``--serve``) or run the
  seeded smoke (``--smoke``): replay a ``tools/traffic.py`` scenario
  through the door and print a serve_bench-style SLA row as the last
  stdout line (client-side request and token counts, the router's and
  supervisor's counters, the fleet ledger's audit, prefix-hit tokens
  summed over the replicas' ``/vars``, the page-balance audit). This
  process holds no engine and never initialises CUDA.

    python -m distributed_training_tpu_torch.tools.serve_net --smoke --device cpu \\
        --replicas 2 --requests 24 --policy prefix
    python -m distributed_training_tpu_torch.tools.serve_net --smoke --device cpu \\
        --journal-dir j --kill-replica-at-request 3 --breaker-threshold 1 \\
        --breaker-cooldown-s 600 --trace-dir tr
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The replica's engine flags, forwarded by ReplicaProc as they are.
ENGINE_FLAGS = ("vocab_size", "num_layers", "num_heads", "hidden_dim", "model_max_len",
                "max_batch", "max_len", "max_new_tokens", "temperature", "kv_page_size",
                "kv_pages", "seed", "device")


def add_engine_args(p: argparse.ArgumentParser) -> None:
    """The engine flags a replica takes (a random-weight model: this
    drills the network plane, not the model)."""
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=2)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--model-max-len", type=int, default=256)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-len", type=int, default=192)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--kv-page-size", type=int, default=8)
    p.add_argument("--kv-pages", type=int, default=256)
    p.add_argument("--no-prefix-cache", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="the replicas' device: cpu, or the card by default "
                        "(a replica without one fails)")
    p.add_argument("--journal-dir", type=str, default=None)
    p.add_argument("--trace-dir", type=str, default=None,
                   help="fleet tracing: the door and every replica "
                        "incarnation write one trace here, named by its real "
                        "pid; tools/fleet_trace.py merges them")


def engine_config(args: argparse.Namespace):
    """The replica's ``ServeConfig`` (JAX's serve_net choices)."""
    from distributed_training_tpu_torch.config import ServeConfig

    return ServeConfig(
        max_batch=args.max_batch, max_len=args.max_len,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature,
        kv_page_size=args.kv_page_size or None, kv_pages=args.kv_pages,
        prefix_cache=not args.no_prefix_cache, journal_dir=args.journal_dir,
        seed=args.seed)


def build_engine(args: argparse.Namespace, trace=None):
    """A replica's engine over the seeded random-weight model."""
    import torch

    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.serving import Engine
    from distributed_training_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = get_model("transformer_lm", num_classes=args.vocab_size,
                      num_layers=args.num_layers, num_heads=args.num_heads,
                      hidden_dim=args.hidden_dim, max_len=args.model_max_len,
                      generator=torch.Generator().manual_seed(args.seed))
    return Engine(model.to(device), engine_config(args), trace=trace)


def run_replica(args: argparse.Namespace) -> int:
    from distributed_training_tpu_torch.observability.trace import fleet_session
    from distributed_training_tpu_torch.serving.frontend import ServingFrontend

    # The session's pid is os.getpid() and the file carries it, so a killed
    # incarnation's trace survives its successor's; fleet_trace's
    # --check-failover keys on the "replica" prefix.
    trace, trace_path = fleet_session(f"replica-{args.name}", args.trace_dir)
    engine = build_engine(args, trace=trace)
    engine.recover()
    frontend = ServingFrontend(engine, port=args.port, trace=trace,
                               trace_path=trace_path).start()
    print(json.dumps({"replica": args.name, "port": frontend.port}), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        # Park until the parent closes the pipe or SIGTERMs.
        while not stop.is_set():
            if not sys.stdin.read(1):
                break
    except (KeyboardInterrupt, OSError):
        pass
    frontend.stop()
    if engine.journal is not None:
        engine.journal.shutdown()
    return 0


class ReplicaProc:
    """One replica subprocess and the port it reported. The constructor
    blocks until the port line (after the replica's journal replay);
    ``start_s`` is how long that took."""

    def __init__(self, index: int, args: argparse.Namespace):
        cmd = [sys.executable, "-m", "distributed_training_tpu_torch.tools.serve_net",
               "--replica", "--name", f"r{index}", "--port", "0"]
        for flag in ENGINE_FLAGS:
            cmd += [f"--{flag.replace('_', '-')}", str(getattr(args, flag))]
        if args.no_prefix_cache:
            cmd.append("--no-prefix-cache")
        # Paths absolute: the replica runs from the repo's root.
        if args.journal_dir:
            cmd += ["--journal-dir", os.path.abspath(os.path.join(args.journal_dir,
                                                                  f"r{index}"))]
        if args.trace_dir:
            cmd += ["--trace-dir", os.path.abspath(args.trace_dir)]
        self.name = f"r{index}"
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"replica {self.name} died before reporting its port "
                               f"(exit {self.proc.wait()})")
        self.start_s = time.perf_counter() - t0
        self.port = int(json.loads(line)["port"])
        self.url = f"http://127.0.0.1:{self.port}"
        print(f"[serve_net] replica {self.name} (pid {self.proc.pid}) up on port "
              f"{self.port} in {self.start_s:.2f} s", file=sys.stderr, flush=True)

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()  # the replica parks on stdin's end
                self.proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()


def _post_json(url: str, timeout_s: float) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=b"{}",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def replica_stats(url: str) -> dict:
    """One replica's serving stats, from its ``/vars``."""
    import urllib.request

    with urllib.request.urlopen(url + "/vars", timeout=10.0) as resp:
        return json.loads(resp.read())["serving"]


def settle_and_audit(sup, timeout_s: float = 60.0) -> tuple[list, int]:
    """After a replay: wait for each replica to go idle (a killed one may
    still be restarting, or finishing its recovered work), run its page
    balance audit and read its ``/vars``. Returns (stats a replica,
    balance violations); a replica that never settles counts as a
    violation. ``sup.handles[i]`` is read again every poll: a restart
    swaps the handle."""
    stats, violations = [], 0
    for i in range(len(sup.handles)):
        t0 = time.monotonic()
        audited = False
        while time.monotonic() - t0 < timeout_s:
            h = sup.handles[i]
            try:
                probe = _post_json(h.url + "/probe", 5.0)
                if probe.get("queue_depth", 1) or probe.get("active_slots", 1):
                    time.sleep(0.1)
                    continue
                verdict = _post_json(h.url + "/admin/check_balanced", 10.0)
                if not verdict.get("balanced", False):
                    print(f"[serve_net] BALANCE VIOLATION on {h.name}: "
                          f"{verdict.get('error')}", file=sys.stderr)
                    violations += 1
                stats.append(replica_stats(h.url))
                audited = True
                break
            except Exception:
                time.sleep(0.25)  # mid-restart: keep polling
        if not audited:
            print(f"[serve_net] replica {sup.handles[i].name} never settled for the "
                  f"balance audit", file=sys.stderr)
            violations += 1
            stats.append({})
    return stats, violations


def fleet_row(*, scenario: str, results: list, dropped: set, router, sup, door,
              per_replica: list, balance_violations: int, concurrency: int,
              wall_s: float) -> dict:
    """The smoke's SLA row (JAX's keys): the client's counts, the router's,
    the supervisor's and the fleet ledger's counters, the fleet's
    prefix-hit tokens from ``per_replica``'s stats; ``wall_s`` is
    context only."""
    from distributed_training_tpu_torch.tools.traffic import trace_roundtrip_mismatches

    done = [r for r in results if r is not None]
    snap = router.router_snapshot()
    sup_snap = sup.supervisor_snapshot()
    fleet = door.fleet_snapshot()
    return {
        "scenario": scenario,
        "requests": len(results),
        "requests_finished": len(done),
        # A chaos-dropped client is an injected fault, not a failure.
        "requests_failed": sum(1 for i, r in enumerate(results)
                               if r is None and i not in dropped),
        "tokens_emitted": sum(len(r["tokens"]) for r in done),
        "stream_vs_done_mismatches": sum(
            1 for r in done if r.get("streamed_tokens") is not None
            and r["streamed_tokens"] != r["tokens"]),
        "replicas": len(router.replicas),
        "concurrency": concurrency,
        "router_requests_routed": snap["router_requests_routed"],
        "router_prefix_routed": snap["router_prefix_routed"],
        "router_fallback_routed": snap["router_fallback_routed"],
        "router_retries": snap["router_retries"],
        "router_deploys_completed": snap["router_deploys_completed"],
        "router_deploy_errors": snap["router_deploy_errors"],
        "replica_restarts": sup_snap["replica_restarts"],
        "breaker_opens": snap["router_breaker_opens"],
        "failover_resumes": snap["router_failover_resumes"],
        "fleet_ledger_requests": fleet["fleet_ledger_requests"],
        "fleet_ledger_conservation_violations":
            fleet["fleet_ledger_conservation_violations"],
        "fleet_replica_ledger_joined": fleet["fleet_replica_ledger_joined"],
        "fleet_replica_ledger_absent": fleet["fleet_replica_ledger_absent"],
        "trace_roundtrip_mismatches": trace_roundtrip_mismatches(results),
        "requests_cancelled": sum(int(s.get("requests_cancelled", 0)) for s in per_replica),
        "balance_violations": balance_violations,
        "prefix_cache_hit_tokens": sum(int(s.get("prefix_cache_hit_tokens", 0))
                                       for s in per_replica),
        "prefix_cache_hit_requests": sum(int(s.get("prefix_cache_hit_requests", 0))
                                         for s in per_replica),
        "wall_s": round(wall_s, 3),
    }


def row_ok(row: dict) -> bool:
    """The smoke's gate: no failed request, no stream mismatch, no deploy
    error, no page leak, no fleet-ledger violation, no trace mismatch."""
    return not (row["requests_failed"] or row["stream_vs_done_mismatches"]
                or row["router_deploy_errors"] or row["balance_violations"]
                or row["fleet_ledger_conservation_violations"]
                or row["trace_roundtrip_mismatches"])


def run_front_door(args: argparse.Namespace) -> int:
    from distributed_training_tpu_torch.observability.trace import fleet_session
    from distributed_training_tpu_torch.serving.router import (
        HttpReplica,
        Router,
        RouterFrontDoor,
    )
    from distributed_training_tpu_torch.serving.supervisor import ReplicaSupervisor
    from distributed_training_tpu_torch.tools.traffic import make_scenario, replay_over_http

    # One trace for the door's process, shared by the router (breaker
    # skips) and the supervisor (deaths, restarts).
    trace, trace_path = fleet_session("door", args.trace_dir)
    router_box: list = []

    def _on_restart(i: int, handle) -> None:
        # Point the router's client at the replacement's port; the breaker
        # keeps traffic off it until a trial succeeds.
        if router_box:
            router_box[0].replicas[i].url = handle.url.rstrip("/")
        print(f"[serve_net] supervisor restarted {handle.name} on port {handle.port}",
              file=sys.stderr)

    sup = ReplicaSupervisor(lambda i: ReplicaProc(i, args), args.replicas,
                            wedge_timeout_s=args.wedge_timeout_s or None,
                            on_restart=_on_restart, trace=trace).start()
    replicas = sup.handles
    router = Router([HttpReplica(r.url, name=r.name) for r in replicas],
                    policy=args.policy, breaker_threshold=args.breaker_threshold,
                    breaker_cooldown_s=args.breaker_cooldown_s)
    router_box.append(router)

    # Chaos: SIGKILL the replica serving request N after its first relayed
    # token (mid-stream), through the supervisor's handle.
    kill_state = {"killed": False}

    def _chaos_hook(seq: int, delivered: int, replica_idx) -> None:
        if (args.kill_replica_at_request > 0 and not kill_state["killed"]
                and seq == args.kill_replica_at_request and delivered >= 1
                and replica_idx is not None):
            kill_state["killed"] = True
            print(f"[serve_net] chaos: SIGKILL replica {replica_idx} mid-stream "
                  f"(request {seq}, {delivered} tokens delivered)", file=sys.stderr)
            sup.kill(replica_idx)

    door = RouterFrontDoor(
        router, port=args.port,
        chaos_hook=_chaos_hook if args.kill_replica_at_request > 0 else None,
        trace=trace, trace_path=trace_path,
        supervisor_snapshot=sup.supervisor_snapshot).start()
    print(json.dumps({"port": door.port, "policy": args.policy,
                      "replicas": [{"name": r.name, "port": r.port} for r in replicas]}),
          flush=True)
    try:
        if not args.smoke:
            print(f"[serve_net] front door on {door.url('')} ({args.replicas} "
                  f"replica(s), policy={args.policy}); Ctrl-C or stdin's end to stop",
                  file=sys.stderr)
            try:
                while sys.stdin.read(1):
                    pass
            except KeyboardInterrupt:
                pass
            return 0

        reqs = make_scenario(
            args.scenario, seed=args.seed, requests=args.requests, rate=args.rate,
            mean_prompt_len=args.mean_prompt_len, max_prompt_len=args.max_prompt_len,
            max_new_tokens=args.max_new_tokens, vocab_size=args.vocab_size,
            budget=args.max_len)
        deploy_thread = None
        if args.rolling_deploy_at > 0:
            # The rolling deploy fires mid-load from a side thread; requests
            # keep flowing through the rotation.
            def _deploy() -> None:
                time.sleep(args.rolling_deploy_delay_s)
                router.rolling_deploy()

            deploy_thread = threading.Thread(target=_deploy, name="chaos-deploy",
                                             daemon=True)
            deploy_thread.start()
        drop_at = None
        if args.drop_client_at_token > 0:
            drop_at = {args.drop_client_at_request - 1: args.drop_client_at_token}
        t0 = time.monotonic()
        results = replay_over_http(door.url("/generate"), reqs, stream=not args.unary,
                                   concurrency=args.concurrency,
                                   timeout_s=args.timeout_s, drop_at=drop_at)
        wall_s = time.monotonic() - t0
        if deploy_thread is not None:
            deploy_thread.join(timeout=120.0)
        if args.completions_out:
            with open(args.completions_out, "w") as fh:
                json.dump([{"index": i, "uid": int(r["uid"]), "reason": r["finish_reason"],
                            "tokens": [int(t) for t in r["tokens"]]}
                           for i, r in enumerate(results) if r is not None], fh)
            print(f"[serve_net] completions: {args.completions_out}", file=sys.stderr)
        # The audit first: it waits out a restart in flight and a cancel
        # that lands a step after its client left, so the counters read
        # after it are settled.
        chaos = bool(drop_at) or kill_state["killed"]
        per_replica, balance_violations = settle_and_audit(
            sup, timeout_s=120.0 if chaos else 20.0)
        if args.fleet_out:
            # The federated plane, scraped after the replay settled.
            import urllib.request

            fleet_doc = {}
            for key, path in (("metrics_text", "/fleet/metrics"), ("vars", "/fleet/vars"),
                              ("replicas", "/fleet/replicas")):
                with urllib.request.urlopen(door.url(path), timeout=30.0) as resp:
                    body = resp.read().decode("utf-8", "replace")
                fleet_doc[key] = body if key == "metrics_text" else json.loads(body)
            with open(args.fleet_out, "w") as fh:
                json.dump(fleet_doc, fh)
            print(f"[serve_net] fleet scrape: {args.fleet_out}", file=sys.stderr)
        row = fleet_row(scenario=args.scenario, results=results, dropped=set(drop_at or ()),
                        router=router, sup=sup, door=door, per_replica=per_replica,
                        balance_violations=balance_violations,
                        concurrency=args.concurrency, wall_s=wall_s)
        print(json.dumps(row, allow_nan=False))
        if row["fleet_ledger_conservation_violations"]:
            print(f"[serve_net] FLEET LEDGER VIOLATION: "
                  f"{door.fleet_snapshot()['fleet_ledger_violation_last']}",
                  file=sys.stderr)
        return 0 if row_ok(row) else 1
    finally:
        door.stop()
        sup.stop()
        if trace is not None and trace_path:
            trace.save(trace_path)
            print(f"[serve_net] trace: {trace_path} ({len(trace)} events)",
                  file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.tools.serve_net",
        description="network serving: replicas behind a cache-aware front door")
    p.add_argument("--replica", action="store_true", default=False,
                   help="run ONE replica (engine and frontend) in this process")
    p.add_argument("--name", type=str, default="r0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--policy", type=str, default="prefix", choices=["prefix", "round_robin"])
    p.add_argument("--serve", action="store_true", default=False,
                   help="front-door mode: serve until interrupted or stdin ends "
                        "(the default without --smoke)")
    p.add_argument("--smoke", action="store_true", default=False,
                   help="replay a seeded scenario through the door and print "
                        "an SLA row")
    p.add_argument("--scenario", type=str, default="shared_prefix")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--rate", type=float, default=16.0)
    p.add_argument("--mean-prompt-len", type=int, default=32)
    p.add_argument("--max-prompt-len", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=1)
    p.add_argument("--unary", action="store_true", default=False)
    p.add_argument("--timeout-s", type=float, default=180.0)
    p.add_argument("--completions-out", type=str, default=None)
    p.add_argument("--fleet-out", type=str, default=None,
                   help="after the replay settles, write the door's "
                        "/fleet/metrics, /fleet/vars and /fleet/replicas here")
    p.add_argument("--rolling-deploy-at", type=int, default=0,
                   help="> 0: a rolling deploy from a side thread mid-replay")
    p.add_argument("--rolling-deploy-delay-s", type=float, default=0.5)
    p.add_argument("--kill-replica-at-request", type=int, default=0,
                   help="SIGKILL the replica serving the Nth routed request "
                        "(1-based) after its first streamed token")
    p.add_argument("--drop-client-at-token", type=int, default=0,
                   help="> 0: hang up one client after K streamed tokens")
    p.add_argument("--drop-client-at-request", type=int, default=1,
                   help="which request (1-based) the drop-client drill hangs up")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive failures before a replica's breaker opens")
    p.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                   help="seconds an open breaker waits before its half-open trial")
    p.add_argument("--wedge-timeout-s", type=float, default=0.0,
                   help="> 0 arms the supervisor's frozen-heartbeat detector")
    add_engine_args(p)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.replica:
        return run_replica(args)
    return run_front_door(args)


if __name__ == "__main__":
    sys.exit(main())
