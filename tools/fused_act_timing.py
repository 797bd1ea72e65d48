"""Where the W4A4 GEMM should fake-quantize x itself: the fused x load of K1
against K2 followed by K1, at the full-width llama3_2_3b linears on one card.

    python3 tools/fused_act_timing.py [--m 4 12 32 64 128 1024] [--src DIR] [--label NAME]
    python3 tools/fused_act_timing.py --k2 [--m 4 128 1024] [--src DIR] [--label NAME]

For each M, one layer's 7 packed linears (random weights from seed 0, x bf16
x 3 from seed 1) run under the activation set (5, -5) two ways through
``razer_matmul_cuda``: ``fused`` (one launch per linear, each column block
quantizing its x tile in the load) and ``two_launch`` (K2, then K1 on its
output).  Per layer it reports:

  device_ms   the kernels' own time from torch.profiler (K1, plus K2 for
              two_launch), over 4 layers' distinct weights cycled so that
              the weights come from device memory, per layer;
  event_ms    CUDA events around the same loop, per layer;
  host_ms     the host's time to issue one layer's calls (no sync inside the
              loop, so the device's time is not in it);

and the largest M at which the fused path's device time is not above the
two-launch path's (in every run), and the largest at which its event time
(what a host-bound decode step pays) is not, by the mean of the runs: the
crossover ``FUSE_ACT_MAX_M`` follows.  Both paths give the same bits
(checked here at each M).
``--src`` picks the directory that holds the ``repro_torch`` package.

``--k2`` times the standalone activation kernel (K2) alone instead: at each
M and each of llama3_2_3b's two input widths (d_model, d_ff), bf16 x from
seed 1, its device time per launch from torch.profiler (L2 flushed before
each run, in turns over 4 runs), beside its byte bound (x read and y
written once over 3.35 TB/s).  It calls only ``razer_act_qdq_cuda(x,
svs)``, so ``--src`` may name a checkout from before the fused path.
Prints one JSON line; exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _k2_alone(args, cs, cfg) -> int:
    """The ``--k2`` mode: K2's device time per launch by (M, K)."""
    import torch

    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    dev = torch.device("cuda", 0)
    gx = torch.Generator(device=dev).manual_seed(1)
    out = {"label": args.label, "src": args.src, "card": cs._require_cuda(), "svs": [5.0, -5.0], "k2": {}}
    for m in args.m:
        for k in (cfg.d_model, cfg.d_ff):
            x = (torch.randn((m, k), generator=gx, device=dev) * 3).to(torch.bfloat16)
            runs = [cs._device_ms(lambda: razer_act_qdq_cuda(x), "razer_act_qdq_kernel", cold=True)[0]
                    for _ in range(4)]
            out["k2"][f"M{m}_K{k}"] = {"device_ms_per_launch": runs,
                                      "bound_ms": cs._bound_ms(2 * 2 * m * k, 0.0)[0]}
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--m", type=int, nargs="+", default=[4, 12, 32, 64, 128, 1024])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--k2", action="store_true", help="time the standalone K2 alone at d_model and d_ff")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("fused_act_timing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config

    if args.k2:
        return _k2_alone(args, cs, get_config("llama3_2_3b"))
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    cfg = get_config("llama3_2_3b")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = cs._linear_shapes(cfg)
    layers = [{name: pack_weight(torch.randn((k, n), generator=g, device=dev) / k**0.5) for name, k, n in shapes}
              for _ in range(4)]
    svs = (5.0, -5.0)
    out = {"label": args.label, "src": args.src, "card": cs._require_cuda(), "svs": svs, "M": {}}
    gx = torch.Generator(device=dev).manual_seed(1)
    for m in args.m:
        xs = {k: (torch.randn((m, k), generator=gx, device=dev) * 3).to(torch.bfloat16) for _, k, _ in shapes}

        def layer(fused: bool, i: int = 0):
            for name, k, _ in shapes:
                pw = layers[i][name]
                razer_matmul_cuda(xs[k], pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0], m1=pw.sv_magnitudes[1],
                                  act_svs=svs, fused=fused)

        for name, k, _ in shapes:  # the two paths' bits
            pw = layers[0][name]
            a, b = (razer_matmul_cuda(xs[k], pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                      m1=pw.sv_magnitudes[1], act_svs=svs, fused=f) for f in (True, False))
            assert torch.equal(a, b), (m, name)
        row = {}
        for fused in (True, False, False, True):  # in turns
            four = lambda: [layer(fused, i) for i in range(4)]  # noqa: E731
            device = cs._device_ms(four, "gemm_kernel<K1,")[0] / 4
            if not fused:
                device += cs._device_ms(four, "razer_act_qdq_kernel")[0] / 4
            event = cs._cuda_ms(four, reps=5) / 4
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                layer(fused)
            host = (time.perf_counter() - t0) * 1e3 / 5
            torch.cuda.synchronize()
            key = "fused" if fused else "two_launch"
            for metric, val in (("device_ms", device), ("event_ms", event), ("host_ms", host)):
                row.setdefault(key, {}).setdefault(metric, []).append(val)
        out["M"][m] = row
    fuse_ok = [m for m in args.m
               if max(out["M"][m]["fused"]["device_ms"]) <= min(out["M"][m]["two_launch"]["device_ms"])]
    out["largest_M_fused_device_not_slower"] = max(fuse_ok) if fuse_ok else None
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    fuse_ok = [m for m in args.m
               if mean(out["M"][m]["fused"]["event_ms"]) <= mean(out["M"][m]["two_launch"]["event_ms"])]
    out["largest_M_fused_event_not_slower"] = max(fuse_ok) if fuse_ok else None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
