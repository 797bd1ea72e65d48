"""Time a part of ``chip_smoke.py`` as it runs and as a cut would run it,
in one process on one card: what that cut saves the script (or what a new
phase costs).  The kernels are built first (``build.build_all``), so no
time below includes nvcc.

    python3 tools/phase_depth_cost.py [--part w4a4|w4|mesh_train|llama4 ...] [--depths 32 16] [--out FILE]

``w4a4`` and ``w4`` time a part of phase 7 on llama3_1_8b at the model's
full depth (32 layers) and at the depth phase 7 runs it.

``--part w4a4`` (the default): random full-width llama3_1_8b weights from
seed 0 (``chip_smoke._engines``'s draw, qkv extras included) are made once
at full depth; at each depth ``chip_smoke._llama8b_w4a4_part`` (the
function phase 7 calls) packs that many layers under W4A4 + KV and runs the
generate and serve part on them (default depths: 32 and
``LLAMA8B_W4A4_LAYERS``).

``--part w4``: at each depth ``chip_smoke._llama8b_w4_part`` (the function
phase 7 calls) draws and packs that many layers under W4 + KV, runs the
generate and serve part (vanilla and speculative) and phases 8 and 9 on
those engines (default depths: 32 and ``LLAMA8B_W4_LAYERS``), with
phase 9's seconds by part at each depth.

``--part llama4``: phases 4, 4b and 4c (``chip_smoke._llama_phase4``, the
engines' packing included) on llama3_2_3b at full width, at 28 layers and
at ``LLAMA_CUT_LAYERS``.

``--part mesh_train``: phase 12 (f) (``chip_smoke._train_mesh``), training
on a mesh: (a) on one NCCL rank, (b) on two ranks sharing the card over
gloo.

Prints one JSON line of host-clock seconds by depth (and by part of the
run) beside the card's name and power limit; exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write the JSON to this file")
    ap.add_argument("--part", choices=("w4a4", "w4", "mesh_train", "llama4"), nargs="+", default=["w4a4"],
                    help="the parts to time, in turn")
    ap.add_argument("--depths", type=int, nargs="+", default=None,
                    help="the depths to time (default: the full depth and the depth phase 7 runs the part at)")
    args = ap.parse_args()

    import chip_smoke as cs

    smi = cs._require_cuda()
    from repro_torch.configs import get_config

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build

    build.build_all()
    cfg = get_config("llama3_1_8b")
    out = {"card": smi, "arch": "llama3_1_8b"}
    for part in args.part:
        out[part] = {"seconds_by_depth": {}}
        if part == "w4a4":
            engines, _ = cs._engines(cfg, dev, policies=("w4_kv",))
            raw = engines.pop("w4_kv")._raw_params
            for n in args.depths or (cfg.num_layers, cs.LLAMA8B_W4A4_LAYERS):
                out[part]["seconds_by_depth"][n] = cs._llama8b_w4a4_part(raw, cfg, n, dev, {})[2]
            del raw
        elif part == "w4":
            out[part]["toolkit_seconds_by_part"] = {}
            for n in args.depths or (cfg.num_layers, cs.LLAMA8B_W4_LAYERS):
                detail = {}
                *_, engines, secs = cs._llama8b_w4_part(cfg, n, dev, detail)
                out[part]["seconds_by_depth"][n] = secs
                out[part]["toolkit_seconds_by_part"][n] = detail["toolkit"]["seconds_by_part"]
        elif part == "llama4":
            for n in args.depths or (28, cs.LLAMA_CUT_LAYERS):
                llama = dataclasses.replace(get_config("llama3_2_3b"), num_layers=n)
                t0 = time.perf_counter()
                engines, pack_s = cs._engines(llama, dev)
                cs._llama_phase4(llama, engines, {}, pack_s)
                out[part]["seconds_by_depth"][n] = time.perf_counter() - t0
                engines = None
                torch.cuda.empty_cache()
        else:
            t0 = time.perf_counter()
            detail = {"phase_s": {}}
            row = cs._train_mesh(dev, detail)
            out[part] = {"total_s": time.perf_counter() - t0, "train_mesh": row}
        engines = None
        torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
