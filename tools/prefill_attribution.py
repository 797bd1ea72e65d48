"""Where the prefill-attention kernel's time goes, on one card: K9's
tensor-core body against variants of it with one part taken out.

    python3 tools/prefill_attribution.py [VARIANT ...]

Each variant is ``src/repro_torch/csrc/prefill_attention.cu`` with a textual
patch, built by nvcc into ``src/repro_torch/build/prefill_attribution/`` (all
in parallel) and timed in this process:

  kernel       the body as shipped: the split, then the attention;
  no_split     the attention alone, on a stale workspace (flags zero);
  split_only   the split alone;
  no_qk_mma    the score wgmmas replaced by an XOR of their descriptors
               into the scores;
  no_pv_mma    the output wgmmas replaced by an XOR of P's fragments into
               the outputs (P's split stays live);
  p_one_part   P as one bf16 part against f32 V (what the mid and lo parts
               of P cost; less accurate);
  no_exp       the softmax's exponentials left out (p = s - m);
  ns32         the P V slices 32 output dims wide (16 accumulators a
               thread) in place of 64;
  nst5_no_lows the shared memory of the low tiles given to two more hi
               stages (a ring of 5, no low region; every chunk taken as
               unflagged, so it is timed on wire K/V only, where it
               computes the output).

Only ``kernel``, ``p_one_part``, ``ns32`` and ``nst5_no_lows`` compute the
output; for them the largest |error| against the plain version
(``kernels.ref``) is measured, and the number of elements outside
PREFILL_TOL's f32-K/V tolerance (rtol 2^-7, atol 1e-6).  Shapes:
llama3_2_3b heads (24 / 8, hd 128), q bf16, K/V through the KV wire format
(f32, exact in bf16: the serving path's), causal, B 1 x 4096 and B 4 x 4096;
also B 1 x 4096 with random f32 K/V (the low-part MMAs run).  CUDA events
around 10 calls after 3 warm-ups.  Prints one JSON line per variant; exits
non-zero if a variant failed to build or run, or without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "src" / "repro_torch" / "build" / "prefill_attribution"

_SPLIT = "  prefill_attention_tc_split_kernel<HD><<<dim3(nch, p.KVH, p.B), 256, Geo<HD>::split_bytes(), st>>>(p);"
_QK = "      wgmma_qk(s, dq, desc(kt + 256 * ks, HD));"
_QK_SINK = "      s[ks & 31] = __int_as_float(__float_as_int(s[ks & 31]) ^ static_cast<int>(dq));"
_PV_LOWS = ("          razer_tile::Wgmma<Gm::NS>::mma(a, pm[kk], dv);\n"
            "          razer_tile::Wgmma<Gm::NS>::mma(a, pl[kk], dv);\n")
_PV = "        razer_tile::Wgmma<Gm::NS>::mma(a, ph[kk], dv);\n        if (!p.v_bf16) {\n" + _PV_LOWS
_PV_SINK = ("        a[kk] = __int_as_float(__float_as_int(a[kk]) ^ ph[kk][0] ^ ph[kk][1] ^ ph[kk][2] ^ ph[kk][3] ^ "
            "pm[kk][0] ^ pm[kk][1] ^ pm[kk][2] ^ pm[kk][3] ^ pl[kk][0] ^ pl[kk][1] ^ pl[kk][2] ^ pl[kk][3] ^ "
            "static_cast<int>(dv));\n        if (!p.v_bf16) {\n")
PATCHES = {
    "kernel": [],
    "no_split": [(_SPLIT, "")],
    "split_only": [("  prefill_attention_tc_kernel<HD><<<grid, 128 * gb, Geo<HD>::bytes(gb), st>>>(p);", "")],
    "no_qk_mma": [(_QK, _QK_SINK)],
    "no_pv_mma": [(_PV, _PV_SINK)],
    "p_one_part": [(_PV_LOWS, "")],
    "no_exp": [(f"s[4 * j{e}] = exp2f(__fsub_rn(s[4 * j{e}], mn{r}));", f"s[4 * j{e}] = __fsub_rn(s[4 * j{e}], mn{r});")
               for e, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))],
    "ns32": [("static constexpr int NS = HD < 64 ? HD : 64;", "static constexpr int NS = HD < 32 ? HD : 32;")],
    "nst5_no_lows": [("static constexpr int NST = 3;", "static constexpr int NST = 5;"),
                     ("return (size_t)(gb + 2 * NST + 4) * KT + 128;", "return (size_t)(gb + 2 * NST) * KT + 128;"),
                     ("reinterpret_cast<uint64_t*>(lows + 4 * Gm::KT);", "reinterpret_cast<uint64_t*>(lows);"),
                     ("    while (c < chunks && !flags[c]) ++c;\n", "    return;\n"),
                     ("const bool low = flags[c] != 0;", "const bool low = false;")],
}
MEASURED = ("kernel", "p_one_part", "ns32", "nst5_no_lows")
WIRE_ONLY = ("nst5_no_lows",)
SHAPES = {"B1_S4096_wire": (1, 4096, "wire"), "B4_S4096_wire": (4, 4096, "wire"), "B1_S4096_f32": (1, 4096, "f32")}


def _build(variant: str) -> subprocess.Popen:
    from repro_torch.kernels import build

    src = (CSRC / "prefill_attention.cu").read_text()
    for old, new in PATCHES[variant]:
        if old not in src:
            raise RuntimeError(f"{variant}: the source no longer holds {old.strip()[:60]!r}")
        src = src.replace(old, new)
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    (d / "prefill_attention.cu").write_text(src)
    cmd = [build._nvcc(), *build.BASE_FLAGS, "-I", str(CSRC), "-o", str(d / "k9.so"), str(d / "prefill_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _inputs(b, s, kind, gen, dev):
    import torch

    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    q = torch.randn((b, s, 24, 128), generator=gen, device=dev).to(torch.bfloat16)
    kv = [torch.randn((b, s, 8, 128), generator=gen, device=dev) for _ in range(2)]
    if kind == "wire":
        kv = [kv_dequantize(*kv_quantize(t), 128) for t in kv]
    return q, *kv


def _time(variant: str, cases) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.prefill_attention import _ARGTYPES

    from repro_torch.kernels.prefill_attention import workspace_shapes

    fn = ctypes.CDLL(str(OUT / variant / "k9.so")).prefill_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    scale = float(np.float32(1.0) / np.sqrt(np.float32(128)))
    out = {"variant": variant}
    for name, (q, k, v) in cases.items():
        if variant in WIRE_ONLY and not name.endswith("_wire"):
            continue
        o = torch.empty_like(q)
        b, s = q.shape[:2]
        ws_shape, flags_shape = workspace_shapes(b, s, 8, 128)
        ws = torch.zeros(ws_shape, dtype=torch.uint8, device=q.device)
        flags = torch.zeros(flags_shape, dtype=torch.int32, device=q.device)

        def call():
            st = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), ws.data_ptr(), flags.data_ptr(), 1, 0, 0,
                    b, s, s, 24, 8, 128, 0, 1, scale, torch.cuda.current_stream().cuda_stream)
            if st:
                raise RuntimeError(f"{variant}: CUDA error {st} at launch")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 10
        if variant in MEASURED:
            want = ref.chunked_attention_ref(q, k, v).float()
            out[f"{name}_max_abs_err"] = float((o.float() - want).abs().max())
            out[f"{name}_outside_tol"] = int((~torch.isclose(o.float(), want, rtol=2**-7, atol=1e-6)).sum())
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("prefill_attribution: CUDA is not available", file=sys.stderr)
        return 1
    variants = sys.argv[1:] or list(PATCHES)
    procs = {v: _build(v) for v in variants}
    failed = False
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"variant": v, "build_failed": log[-3000:]}))
            failed = True
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {name: _inputs(*shape, gen, dev) for name, shape in SHAPES.items()}
    for v in variants:
        if procs[v].returncode:
            continue
        try:
            print(json.dumps(_time(v, cases)), flush=True)
        except RuntimeError as e:
            print(json.dumps({"variant": v, "error": str(e)}))
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
