"""Where the packed GEMM tile's time goes, on one card: the kernel against
variants of it with one part taken out.

    python3 tools/gemm_attribution.py

Each variant is the tile (``src/repro_torch/csrc/razer_matmul_tile.cuh``)
with a textual patch, built by nvcc into ``src/repro_torch/build/attribution/``
and timed in its own process (two libraries holding the same kernels do not
share one CUDA context well):

  kernel       the tile as shipped;
  no_mma       the wgmmas replaced by an XOR of the decoded registers into
               one accumulator (the decode stays live);
  copies_only  neither decode nor wgmma: the cp.async ring alone;
  no_sv        the code-8 (special value) fix-up left out of the decode.

Only ``kernel`` computes the right product; the others exist to be timed.
Shapes: one dbrx_132b MoE layer's 3 banks (E 16, 6144 x 10752 and
10752 x 6144) at M = 4 and 48, and one llama3_2_3b layer's 7 linears
(through the grouped entry point with E = 1) at M = 4 and 128, over random
wire bytes; CUDA events around 10 calls after 3 warm-ups.  Prints one JSON
line per variant, then exits non-zero if a variant failed to build or run.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "src" / "repro_torch" / "build" / "attribution"

_MMA = "  for (int s = 0; s < 4; ++s) Wgmma<NT>::mma(acc, cur[s], kmajor_desc(xs + s * 256));"
_DECODE = "  for (int s = 0; s < 4; ++s) decode_step(cur[s], slot, table, s, q, col);"
_SINK = ("  for (int s = 0; s < 4; ++s)\n    acc[0] = __int_as_float(__float_as_int(acc[0]) ^ cur[s][0] ^ cur[s][1]"
         " ^ cur[s][2] ^ cur[s][3]);")
PATCHES = {
    "kernel": [],
    "no_mma": [(_MMA, _SINK)],
    "copies_only": [(_MMA, ""), (_DECODE, "")],
    "no_sv": [("  return fma_bf16x2(v, entry.x, is8 & entry.y);", "  return fma_bf16x2(v, entry.x, 0u);")],
}


def _build(variant: str) -> pathlib.Path:
    from repro_torch.kernels import build

    tile = (CSRC / "razer_matmul_tile.cuh").read_text()
    for old, new in PATCHES[variant]:
        if old not in tile:
            raise RuntimeError(f"{variant}: the tile no longer holds {old.strip()!r}")
        tile = tile.replace(old, new)
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    (d / "razer_matmul_tile.cuh").write_text(tile)
    (d / "razer_grouped_matmul.cu").write_text((CSRC / "razer_grouped_matmul.cu").read_text())
    lib = d / "razer_grouped_matmul.so"
    r = subprocess.run([build._nvcc(), *build.BASE_FLAGS, "-o", str(lib), str(d / "razer_grouped_matmul.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {variant}:\n{r.stdout}{r.stderr}")
    return lib


def _time(variant: str) -> dict:
    import torch

    from repro_torch.kernels.razer_grouped_matmul import _ARGTYPES
    from repro_torch.kernels.razer_matmul import launch_plan

    fn = ctypes.CDLL(str(_build(variant))).razer_grouped_matmul_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = torch.empty(16 * 128 * 10752, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def wire(e, k, n):
        return (torch.randint(0, 256, (e, k // 2, n), generator=g, device=dev, dtype=torch.uint8),
                torch.randint(0, 256, (e, k // 16, n), generator=g, device=dev, dtype=torch.uint8), k, n)

    def call(x, c, s, e, m, k, n):
        plan = launch_plan(e, m, n, k)
        status = fn(x.data_ptr(), 1, c.data_ptr(), s.data_ptr(), out.data_ptr(), e, m, k, n, plan.nt, plan.splits,
                    plan.k_tiles_per_split, 5.0, 8.0, stream)
        if status:
            raise RuntimeError(f"{variant}: launch failed with CUDA error {status}")

    def ms(run, reps=10):
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            run()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    d, f = 6144, 10752
    banks = [wire(16, d, f), wire(16, d, f), wire(16, f, d)]
    layer = [wire(1, k, n) for _ in range(4) for k, n in
             [(3072, 3072), (3072, 1024), (3072, 1024), (3072, 3072), (3072, 8192), (3072, 8192), (8192, 3072)]]
    row = {"variant": variant, "card": torch.cuda.get_device_name(0)}
    for m in (4, 48):
        xs = {k: torch.randn((16, m, k), generator=g, device=dev).to(torch.bfloat16) for k in (d, f)}
        row[f"K6_dbrx_layer_M{m}_ms"] = ms(lambda: [call(xs[k], c, s, 16, m, k, n) for c, s, k, n in banks])
    for m in (4, 128):  # 4 layers' distinct weights, per layer
        xs = {k: torch.randn((1, m, k), generator=g, device=dev).to(torch.bfloat16) for k in (3072, 8192)}
        row[f"K1_llama_layer_M{m}_ms"] = ms(lambda: [call(xs[k], c, s, 1, m, k, n) for c, s, k, n in layer]) / 4
    return row


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) > 1:  # one variant, in this process
        print(json.dumps(_time(sys.argv[1])))
        return 0
    failed = 0
    for variant in PATCHES:
        r = subprocess.run([sys.executable, __file__, variant], capture_output=True, text=True)
        print(r.stdout.strip() or f"{variant}: failed\n{r.stderr[-3000:]}")
        failed += r.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
