"""Serve launcher of the port (counterpart of ``repro.launch.serve``), on one
rank or on an (ep, tp) serving mesh over ``torch.distributed``.

    python -m repro_torch.launch.serve --arch llama3_2_3b --reduced --packed --kv-quant
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch llama3_2_3b --packed --kv-quant --tp 2 --backend gloo

Random weights from seed 0 (``init_params``) and random prompts from a numpy
generator seeded 0, the same on every rank; every rank serves all requests
and rank 0 prints.  ``--ep``/``--tp`` build the mesh (``--ep 0``: no mesh
unless ``--tp`` > 1); the packed weights' divisibility is checked first, with
the ``expert_shard_size`` / ``kshard_size`` errors.  ``--backend`` names the
process group's backend: NCCL with one rank per card, gloo where ranks share
a card or run on the CPU.

``--disagg`` serves the request stream on prefill and decode replicas behind
a prefix-aware router (``serving.disagg.serve_disagg``), the KV pages
shipped between them in the 4.5-bit wire format (0.28125 of bf16), and
prints the ``DisaggReport``:

    python -m repro_torch.launch.serve --arch llama3_2_3b --packed --kv-quant \
        --disagg --prefill-replicas 2 --decode-replicas 2 --requests 12 --rate 20

``--rate`` draws Poisson arrivals (req/s) for ``--continuous`` and
``--disagg``, ``--prefill-budget`` caps the prompt tokens prefilled per
engine step, and ``--shared-prefix N`` prepends one N-token system prompt to
every request (prefix-cache traffic).

Observability: ``--trace-out`` writes the serve run's Chrome trace-event
JSON (check it with ``tools/check_trace.py``), ``--metrics-out`` the metrics
registry at exit (a JSON snapshot when the path ends in ``.json``, else the
Prometheus text), ``--quant-report OUT.json`` the per-layer quantization
audit of the packed weights before serving (gate it with
``tools/check_bench.py --report``), ``--kv-audit N`` samples the KV
quantization error every Nth prefill into the report's ``kv`` section, and
``--torch-profile DIR`` brackets the serve loop with ``torch.profiler``:

    python -m repro_torch.launch.serve --arch llama3_2_3b --packed --kv-quant --continuous \
        --metrics-out m.json --quant-report q.json --kv-audit 1 --torch-profile prof

``--dry`` is the smoke mode: the reduced config, at most 4 requests, 4 new
tokens and ``max_len`` 64.  ``--draft-policy`` names any registered format
(nvfp4, mxfp4, int4, nf4, fouroversix, razer) or ``bf16``.  The reference
launcher's checkpoint flag is not ported.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

__all__ = ["main", "write_json", "write_metrics"]


def write_json(path: str, doc) -> None:
    """Byte-stable JSON (sorted keys, one-space indent, trailing newline)."""
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def write_metrics(path: str, registry) -> None:
    """A registry's JSON snapshot when ``path`` ends in ``.json``, else its
    Prometheus text."""
    if path.endswith(".json"):
        write_json(path, registry.snapshot())
    else:
        with open(path, "w") as f:
            f.write(registry.expose())


def _write_report(path: str, report, say) -> None:
    write_json(path, report)
    roll = report["rollups"]
    say(f"  quant report: {path} ({roll['layers_audited']} layers audited, min SQNR {roll['min_sqnr_db']} dB, "
        f"SV block rate {roll['sv_block_rate']}, max drift {roll['max_drift']}; gate: python "
        f"tools/check_bench.py --report {path})")


def _export_obs(args, tracer, registry, say) -> None:
    """Flush the --trace-out / --metrics-out files after a serve run."""
    if tracer is not None:
        tracer.export(args.trace_out)
        say(f"  trace: {args.trace_out} ({len(tracer.events)} events; validate: python tools/check_trace.py "
            f"{args.trace_out})")
    if registry is not None:
        write_metrics(args.metrics_out, registry)
        say(f"  metrics: {args.metrics_out}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--packed", action="store_true", help="RaZeR 4.5-bit packed weights")
    ap.add_argument("--kv-quant", action="store_true", help="RaZeR KV cache (App. C.1)")
    ap.add_argument("--ep", type=int, default=0, help="expert-parallel (data) mesh axis size; 0 = no mesh")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel (model) axis size")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged quantized KV pool")
    ap.add_argument("--slots", type=int, default=4, help="decode slots (continuous mode)")
    ap.add_argument("--prefill-budget", type=int, default=256,
                    help="max prompt tokens prefilled per engine step (continuous mode)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction, default=True,
                    help="share prompt-prefix pages between requests (continuous mode)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical system-prompt tokens to every request")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="self-speculative decoding: draft this many tokens per slot per iteration "
                         "(continuous mode)")
    ap.add_argument("--draft-policy", default=None,
                    help="draft-side quantization: a format name (nvfp4) or 'bf16' (default: nvfp4)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson request arrival rate, req/s (0: all at t=0; --continuous and --disagg)")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode serving over wire-format KV page shipments")
    ap.add_argument("--prefill-replicas", type=int, default=1,
                    help="prefill workers, each with its own pool and prefix cache (--disagg)")
    ap.add_argument("--decode-replicas", type=int, default=1,
                    help="decode workers, each with its own pool and slots (--disagg)")
    ap.add_argument("--chunk-tokens", type=int, default=64, help="max prompt tokens per prefill chunk (--disagg)")
    ap.add_argument("--transfer-gbps", type=float, default=0.0,
                    help="modelled prefill -> decode wire bandwidth (0: instantaneous; --disagg)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the serve run (--continuous or --disagg)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry at exit: Prometheus text, or a JSON snapshot when the path "
                         "ends in .json (--continuous or --disagg)")
    ap.add_argument("--quant-report", default=None, metavar="OUT.json",
                    help="write the per-layer quantization audit of the packed weights before serving (needs "
                         "--packed; gate it with tools/check_bench.py --report)")
    ap.add_argument("--kv-audit", type=int, default=0, metavar="N",
                    help="sample the KV quantization error every Nth prefill write into the quant report's 'kv' "
                         "section (0: off; needs --continuous and --quant-report; outputs unchanged)")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="bracket the serve loop with torch.profiler and write its Chrome trace into DIR "
                         "(--continuous)")
    ap.add_argument("--backend", default="nccl", help="torch.distributed backend of the mesh (nccl, gloo)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dry", action="store_true",
                    help="smoke mode: reduced config, at most 4 requests, 4 new tokens and max_len 64")
    ap.add_argument("--init-method", default="env://",
                    help="process-group rendezvous (env:// under torchrun, or file:///path)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.dry:
        args.reduced = True
        args.requests = min(args.requests, 4)
        args.max_new = min(args.max_new, 4)
        args.max_len = min(args.max_len, 64)
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    if args.speculate_k and not args.continuous:
        ap.error("--speculate-k applies to --continuous serving; disaggregated decode workers do not speculate")
    if (args.trace_out or args.metrics_out or args.rate) and not (args.continuous or args.disagg):
        ap.error("--trace-out, --metrics-out and --rate apply to --continuous or --disagg serving")
    if args.torch_profile and not args.continuous:
        ap.error("--torch-profile brackets the single-engine serve loop; add --continuous")
    if args.quant_report and not args.packed:
        # the audit reads wire bytes; a bf16 run has none to read
        ap.error("--quant-report audits the packed wire format, but this run serves bf16 weights; add --packed, "
                 "or use python -m repro_torch.launch.quant_report --mode fakequant")
    if args.kv_audit:
        if not args.continuous:
            ap.error("--kv-audit samples KVPagePool prefill writes; add --continuous")
        if not args.quant_report:
            ap.error("--kv-audit results land in the quant report's 'kv' section; add --quant-report OUT.json")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    mesh, rank, joined = None, 0, False
    if args.ep or args.tp > 1:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_serving_mesh
        from repro_torch.parallel.sharding import expert_shard_size, kshard_size

        if cfg.moe and args.packed and args.ep > 1:
            # fail fast with the divisibility rule instead of replicating a
            # bank the user asked to shard
            expert_shard_size(cfg.n_experts, args.ep)
        if args.packed and args.tp > 1:
            # every packed reduction dim the K-shard path touches: d_model,
            # and the ffn width (the expert trio's for an MoE model)
            kshard_size(cfg.d_model, args.tp)
            kshard_size(cfg.moe_d_ff if cfg.moe else cfg.d_ff, args.tp)
        joined = not dist.is_initialized()
        mesh = make_serving_mesh(ep=args.ep or None, tp=args.tp, backend=args.backend, device=args.device,
                                 init_method=args.init_method)
        rank = mesh.rank
        device = mesh.device
    else:
        device = resolve_device(args.device)

    params = init_params(cfg, seed=0, device=device)
    policy = QuantPolicy.packed(kv_quant=args.kv_quant) if args.packed else QuantPolicy.bf16()
    scfg = ServeConfig(max_len=args.max_len, max_new_tokens=args.max_new, kv_quant=args.kv_quant, quant=policy)
    eng = Engine(params, cfg, scfg, device=device, mesh=mesh)

    say = print if rank == 0 else (lambda *a, **k: None)
    report = kv_auditor = None
    if args.quant_report:
        report = eng.quant_audit(model=args.arch)
        if rank == 0:
            _write_report(args.quant_report, report, say)
        if args.kv_audit:
            from repro_torch.obs import KVAuditor

            kv_auditor = KVAuditor(sample_every=args.kv_audit)

    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(1, cfg.vocab_size, size=args.shared_prefix).tolist()
    reqs = [sys_prompt + rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 16))).tolist()
            for _ in range(args.requests)]
    where = f"mesh (ep={mesh.ep}, tp={mesh.tp}, {mesh.backend})" if mesh is not None else "one rank"
    if args.continuous or args.disagg:
        from repro_torch.obs import MetricsRegistry, Tracer
        from repro_torch.serving.scheduler import Request, SchedulerConfig

        tracer = Tracer() if args.trace_out else None
        registry = MetricsRegistry() if args.metrics_out else None
        # Poisson arrivals: exponential inter-arrival gaps at --rate req/s
        gaps = rng.exponential(1.0 / args.rate, size=len(reqs)) if args.rate > 0 else np.zeros(len(reqs))
        arrivals = np.cumsum(gaps)
        stream = [Request(rid=i, prompt=p, max_new_tokens=args.max_new, arrival=float(arrivals[i]))
                  for i, p in enumerate(reqs)]
    if args.disagg:
        from repro_torch.serving.disagg import serve_disagg

        rep = serve_disagg(eng, stream, trace=tracer, metrics=registry, n_prefill=args.prefill_replicas,
                           n_decode=args.decode_replicas, chunk_tokens=args.chunk_tokens, max_slots=args.slots,
                           prefix_cache=args.prefix_cache, transfer_gbps=args.transfer_gbps)
        say(f"{rep.new_tokens} tokens / {rep.wall_time:.2f}s makespan | {rep.n_prefill}P x {rep.n_decode}D | "
            f"prefill {rep.prefill_tokens_per_s:.1f} tok/s, decode {rep.decode_tokens_per_s:.1f} tok/s ({where})")
        say(f"  mean TTFT {rep.mean_ttft * 1e3:.1f} ms | mean latency {rep.mean_latency * 1e3:.1f} ms | "
            f"{rep.shipments} shipments, {rep.transfer_bytes / 1024:.1f} KiB shipped "
            f"({rep.transfer_ratio:.5f}x of bf16)")
        say(f"  router: {rep.router_placements} placements, {rep.router_hit_rate:.0%} predicted hit rate | "
            f"realized {rep.cache_hit_rate:.0%} ({rep.cached_tokens} cached vs {rep.prefill_tokens} computed "
            f"prompt tokens)")
        outputs = [r.out_tokens for r in rep.requests]
    elif args.continuous:
        rep = eng.serve(stream, sched_cfg=SchedulerConfig(max_slots=args.slots,
                                                          prefill_token_budget=args.prefill_budget),
                        prefix_cache=args.prefix_cache, speculate_k=args.speculate_k,
                        draft_policy=args.draft_policy, trace=tracer, metrics=registry, kv_audit=kv_auditor,
                        profile_dir=args.torch_profile)
        if kv_auditor is not None and rank == 0:
            # re-emit with the live-serving KV error section filled in
            report["kv"] = kv_auditor.snapshot()
            _write_report(args.quant_report, report, say)
        say(f"{rep.new_tokens} tokens / {rep.wall_time:.2f}s = {rep.tokens_per_s:.1f} tok/s over "
            f"{rep.decode_steps} decode steps (slots={args.slots}, packed={args.packed}, {where})")
        if rep.speculate_k:
            say(f"  speculative k={rep.speculate_k}: accept rate {rep.accept_rate:.0%}")
        outputs = [r.out_tokens for r in rep.requests]
    else:
        t0 = time.perf_counter()
        out = eng.generate(reqs)
        dt = time.perf_counter() - t0
        outputs = [o[len(r):] for o, r in zip(out, reqs)]
        new = sum(len(o) for o in outputs)
        say(f"{new} tokens / {dt:.2f}s = {new / dt:.1f} tok/s (packed={args.packed}, "
            f"kv_quant={args.kv_quant}, {where})")
    for o, r in zip(outputs[:3], reqs[:3]):
        say(f"  prompt[{len(r)}] -> {list(o)}")
    if (args.continuous or args.disagg) and rank == 0:
        _export_obs(args, tracer, registry, say)
    if joined:  # leave a process group the caller set up to the caller
        dist.destroy_process_group()
    return outputs


if __name__ == "__main__":
    with torch.no_grad():
        main()
