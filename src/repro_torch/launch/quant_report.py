"""Per-layer quantization audit of a model config, on the card (the port's
counterpart of ``tools/quant_report.py``).

    python -m repro_torch.launch.quant_report --arch llama3_1_8b --out report.json
    python -m repro_torch.launch.quant_report --arch llama3_2_3b --reduced --device cpu --out /tmp/r.json
    python tools/check_bench.py --report /tmp/r.json

Builds the arch's params (``init_params`` seed 0, the weights the port's
serve launcher uses), resolves the quantization policy and runs
``obs.numerics.audit_model`` on ``--device`` (the GPU unless ``cpu`` is
asked for): per-layer SQNR / MSE / max-abs-err against the reference
weights, FP4 code histograms with SV-remap hit rates, scale-code clipping and
underflow counts, and the packed-vs-fakequant drift (exactly 0 for razer).
The JSON is byte-stable (sorted keys, 9-significant-digit floats) and
schema-versioned (``razer-quant-report/v1``); the report is validated before
it is written, and a schema violation exits 1.

``--mode auto`` (default) audits the wire format when the format packs
(razer) and the fakequant path otherwise (nvfp4).  ``--metrics-out`` /
``--trace-out`` land the same numbers in a metrics dump and a Chrome trace.
``--dry`` forces the reduced config.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch.serve import write_json, write_metrics

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, help="config name (repro_torch.configs)")
    ap.add_argument("--reduced", action="store_true", help="reduced config (test-sized shapes)")
    ap.add_argument("--format", default="razer", help="registered quant format to audit (default razer)")
    ap.add_argument("--mode", choices=("auto", "packed", "fakequant"), default="auto",
                    help="auto = packed wire-byte audit when the format packs, fakequant otherwise")
    ap.add_argument("--out", default=None, metavar="OUT.json",
                    help="write the report JSON here (default: the summary only)")
    ap.add_argument("--metrics-out", default=None,
                    help="also export per-layer gauges + rollups as a metrics snapshot (.json) or Prometheus text")
    ap.add_argument("--trace-out", default=None,
                    help="also drop one quant_audit instant per layer into a Chrome trace-event JSON")
    ap.add_argument("--max-layer-series", type=int, default=256, help="cardinality guard for per-layer gauges")
    ap.add_argument("--dry", action="store_true", help="smoke mode: force the reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.dry:
        args.reduced = True

    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.registry import format_names, get_format
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.obs.numerics import audit_model, validate_report

    if args.format not in format_names():
        ap.error(f"unknown format {args.format!r}; registered: {', '.join(format_names())}")
    packs = get_format(args.format).pack_fn is not None
    mode = args.mode if args.mode != "auto" else ("packed" if packs else "fakequant")
    if mode == "packed" and not packs:
        ap.error(f"format {args.format!r} has no packed wire format (no pack_fn registered); use --mode fakequant")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=0, device=args.device)
    policy = QuantPolicy.packed(args.format) if mode == "packed" else QuantPolicy.fakequant(args.format)
    metrics = MetricsRegistry() if args.metrics_out else None
    tracer = Tracer() if args.trace_out else None

    with torch.no_grad():
        report = audit_model(params, policy, model=args.arch, metrics=metrics, tracer=tracer,
                             max_layer_series=args.max_layer_series)
    bad = validate_report(report)
    if bad:  # the emitter violating its own schema is a bug, not a warning
        print("\n".join(bad))
        print(f"\n{len(bad)} schema violation(s) in the generated report")
        return 1

    roll = report["rollups"]
    print(f"{args.arch} [{args.format}/{mode}]: {roll['layers_audited']} layers audited, {roll['layers_dense']} "
          f"dense ({roll['params_quantized']}/{roll['params_total']} params quantized)")
    for layer in report["layers"]:
        sv = layer.get("sv") or {}
        print(f"  {layer['path']}: sqnr {layer.get('sqnr_db')} dB, sv_block_rate {sv.get('block_rate')}, "
              f"drift {layer.get('drift_max_abs')}")
    print(f"rollups: min_sqnr {roll['min_sqnr_db']} dB (worst: {roll['worst_layer']}), sv_block_rate "
          f"{roll['sv_block_rate']}, max_drift {roll['max_drift']}, wire {roll['wire_bytes']} bytes")
    if args.out:
        write_json(args.out, report)
        print(f"report: {args.out} (gate: python tools/check_bench.py --report {args.out})")
    if metrics is not None:
        write_metrics(args.metrics_out, metrics)
        print(f"metrics: {args.metrics_out}")
    if tracer is not None:
        tracer.export(args.trace_out)
        print(f"trace: {args.trace_out} ({len(tracer.events)} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
