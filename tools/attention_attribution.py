"""Where the decode-attention body's time goes, on one card: the contiguous
kernel K3 against variants of it with one part taken out.

    python3 tools/attention_attribution.py [VARIANT ...]

Each variant is the body (``src/repro_torch/csrc/razer_kv_attend.cuh``) with
a textual patch, built by nvcc with ``razer_kv_attention.cu`` into
``src/repro_torch/build/attention_attribution/`` and timed in its own process:

  kernel       the body as shipped;
  whole_split  a staging ring of a whole split's four chunks in place of two;
  no_qk_mma    the score mma.syncs replaced by an XOR of the decoded K
               registers into the scores (the decode stays live);
  no_pv_mma    the same for the output mma.syncs (the V decode stays live);
  copies_only  no scores, softmax or outputs: the staging, the barriers,
               the partials and the split combine;
  partials_only  the partials written, no ticket, no split combine;
  no_combine_math  the tickets taken, the split combines left out;
  launch_only  every block returns once it knows its split;
  copies_bare  copies_only, returning after the chunks;
  copies_partials  copies_only up to the partials: no ticket, no combine;
  no_copies    copies_only without the copies;
  split_512    splits of 512 positions in place of 256 (half the blocks);
  blocks_4, blocks_8  registers capped for 4 or 8 resident blocks of the
               main path's instantiation in place of 6;
  no_lo_parts  q and P as one bf16 part each, their low parts zero (what
               the high/low split buys in accuracy).

Only ``kernel``, ``whole_split``, ``split_512`` and ``blocks_*`` compute the
right output, ``no_lo_parts`` a less accurate one; for these the largest
|error| against the plain version (``kernels.ref``) is measured on KV-
quantized caches at the two long shapes (``chip_smoke.py``'s phase-3
cases).  The others exist to be timed (a variant that drops the partial lets the
compiler drop the output math with it: ``copies_bare`` skips the math
explicitly).  Shapes: llama3_2_3b heads (G 3, hd 128) over random wire bytes, B 16 at
4096 positions (one sequence at 4001) and B 1 at 32768 with KVH 8, and B 128
at 4096 with KVH 1 (the same bytes, each block's rows contiguous); CUDA
events around 20 calls after 3 warm-ups.  Prints one JSON line per variant,
then exits non-zero if a variant failed to build or run.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "src" / "repro_torch" / "build" / "attention_attribution"

_QK = "if (nt < NT) mma_bf16(sc[nt], a, qfrag[(nt * Gm::NKS + s) * 32 + lane]);"
_PV = "if (nt < NT) mma_bf16(acc[nt][j], a, pfrag[(nt * (CHUNK / 16) + kk) * 32 + lane]);"
_SINK = "if (nt < NT) {0}[0] = __int_as_float(__float_as_int({0}[0]) ^ a[0] ^ a[1] ^ a[2] ^ a[3]);"
_QK_PHASE = "    if (c0 + 16 * warp < s1) {"
_SOFTMAX = "      if (row < R) {\n        const int len"
_PV_PHASE = "    if (mw > 0) {"
_NO_MATH = [(_QK_PHASE, "    if (false) {"), (_SOFTMAX, "      if (row < 0) {\n        const int len"),
            (_PV_PHASE, "    if (false) {")]
_START = "  if (split >= nsplit) return;\n"
_PARTIAL = "  // ---- this split's partial: acc (R, HD)"
_TICKETS = "  if (nsplit == 1) {  // the only split: combine it alone"
_COMBINE = "  const int tid = threadIdx.x;\n  if (tid < R) {"
_STAGE = "    if (c < nchunks) {\n      stage_array<Gm::KC>(buf, Gm::KCS,"
_RING = "constexpr int NSTAGE = 2; "
_MINB = "  static constexpr int value = NTM <= 2 ? 6 : NTM <= 4 ? 4 : 2;"
PATCHES = {
    "kernel": [],
    "whole_split": [(_RING, "constexpr int NSTAGE = SPLIT / CHUNK; ")],
    "no_qk_mma": [(_QK, _SINK.format("sc[nt]"))],
    "no_pv_mma": [(_PV, _SINK.format("acc[nt][j]"))],
    "copies_only": _NO_MATH,
    "partials_only": [(_TICKETS, "  return;\n" + _TICKETS)],
    "no_combine_math": [(_COMBINE, "  return;\n" + _COMBINE)],
    "launch_only": [(_START, _START + "  return;\n")],
    "copies_bare": _NO_MATH + [(_PARTIAL, "  return;\n" + _PARTIAL)],
    "copies_partials": _NO_MATH + [(_TICKETS, "  return;\n" + _TICKETS)],
    "no_copies": _NO_MATH + [(_STAGE, "    if (false) {\n      stage_array<Gm::KC>(buf, Gm::KCS,")],
    "split_512": [("constexpr int SPLIT = 256;", "constexpr int SPLIT = 512;")],
    "blocks_4": [(_MINB, _MINB.replace("? 6 :", "? 4 :"))],
    "blocks_8": [(_MINB, _MINB.replace("? 6 :", "? 8 :"))],
    "no_lo_parts": [("h[e] = g2 < 4 ? hi : bf16_bits_rn(__fsub_rn(v, bf16_value(hi)));", "h[e] = g2 < 4 ? hi : 0u;"),
                    ("lo = bf16_bits_rn(__fsub_rn(pv, bf16_value(hi)));", "lo = 0u;")],
}
# variants whose output is measured against the plain version
MEASURED = ("kernel", "whole_split", "split_512", "blocks_4", "blocks_8", "no_lo_parts")
# name -> (lengths, kv heads); llama3_2_3b's G = 3 and hd 128.  B128_L4096_KVH1
# holds B16_L4096's bytes with one kv head, so that a block's rows are
# contiguous in memory rather than one 64-byte head row in eight.
SHAPES = {"B16_L4096": ([4001] + [4096] * 15, 8), "B1_L32768": ([32768], 8),
          "B128_L4096_KVH1": (([4001] + [4096] * 15) * 8, 1)}


def _build(variant: str) -> subprocess.Popen:
    from repro_torch.kernels import build

    body = (CSRC / "razer_kv_attend.cuh").read_text()
    for old, new in PATCHES[variant]:
        if old not in body:
            raise RuntimeError(f"{variant}: the body no longer holds {old.strip()!r}")
        body = body.replace(old, new)
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    (d / "razer_kv_attend.cuh").write_text(body)
    (d / "razer_kv_attention.cu").write_text((CSRC / "razer_kv_attention.cu").read_text())
    cmd = [build._nvcc(), *build.BASE_FLAGS, "-o", str(d / "k3.so"), str(d / "razer_kv_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _time(variant: str) -> dict:
    import torch

    from repro_torch.kernels import attention_plan
    from repro_torch.kernels.razer_kv_attention import _ARGTYPES

    lib = ctypes.CDLL(str(OUT / variant / "k3.so"))
    fn = lib.razer_kv_attention_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    g, hd = 3, 128
    out = {"variant": variant}
    for name, (lengths, kvh) in SHAPES.items():
        h = g * kvh
        b, s = len(lengths), max(lengths)
        caches = [torch.randint(0, 256, (b, s, kvh, w), generator=gen, device=dev, dtype=torch.uint8)
                  for w in (hd // 2, hd // 16, hd // 2, hd // 16)]
        q = torch.randn((b, h, hd), generator=gen, device=dev)
        cur = torch.tensor(lengths, dtype=torch.int32, device=dev)
        o = torch.empty_like(q)
        ws, tickets = attention_plan.workspace(dev, *attention_plan.workspace_size(b, kvh, s, h // kvh, hd))
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            st = fn(q.data_ptr(), *(c.data_ptr() for c in caches), cur.data_ptr(), o.data_ptr(), ws.data_ptr(),
                    tickets.data_ptr(), b, s, kvh, h // kvh, hd, stream)
            if st:
                raise RuntimeError(f"{variant}: CUDA error {st} at launch")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 20
        del caches
        torch.cuda.empty_cache()
    if variant in MEASURED:
        out["max_abs_err"] = _errors(fn, dev, g, hd)
    return out


def _errors(fn, dev, g, hd):
    """Largest |K3 variant - plain| at chip_smoke's long shapes, on
    KV-quantized random caches (seed 1)."""
    import types

    import torch

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import attention_plan, ref

    cfg = types.SimpleNamespace(num_heads=8 * g, num_kv_heads=8, hd=hd)
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    for name, lengths in cs.LONG_ATTENTION.items():
        _, _, caches, q, cur = cs._attention_case(cfg, dev, gen, lengths)
        b, s = caches[0].shape[:2]
        o = torch.empty_like(q)
        ws, tickets = attention_plan.workspace(dev, *attention_plan.workspace_size(b, 8, s, g, hd))
        st = fn(q.data_ptr(), *(c.data_ptr() for c in caches), cur.data_ptr(), o.data_ptr(), ws.data_ptr(),
                tickets.data_ptr(), b, s, 8, g, hd, torch.cuda.current_stream().cuda_stream)
        if st:
            raise RuntimeError(f"CUDA error {st} at launch")
        errs[name] = float((o - ref.razer_kv_attention_ref(q, *caches, cur)).abs().max())
        del caches
        torch.cuda.empty_cache()
    return errs


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps(_time(sys.argv[2])))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attention_attribution: CUDA is not available", file=sys.stderr)
        return 1
    variants = sys.argv[1:] or list(PATCHES)
    procs = {v: _build(v) for v in variants}
    failed = False
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"variant": v, "build_failed": log[-2000:]}))
            failed = True
    for v in variants:
        if procs[v].returncode == 0:
            run = subprocess.run([sys.executable, __file__, "--time", v], capture_output=True, text=True)
            print(run.stdout.strip() if run.returncode == 0 else json.dumps({"variant": v, "error": run.stderr[-2000:]}))
            failed |= run.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
