"""Time a part of ``chip_smoke.py`` phase 7 on llama3_1_8b at the model's
full depth (32 layers) and at the depth phase 7 runs it, in one process on
one card: what that cut saves the script.

    python3 tools/phase_depth_cost.py [--part w4a4|w4] [--depths 32 16] [--out FILE]

``--part w4a4`` (the default): random full-width llama3_1_8b weights from
seed 0 (``chip_smoke._engines``'s draw, qkv extras included) are made once
at full depth; at each depth ``chip_smoke._llama8b_w4a4_part`` (the
function phase 7 calls) packs that many layers under W4A4 + KV and runs the
generate and serve part on them (default depths: 32 and
``LLAMA8B_W4A4_LAYERS``).

``--part w4``: at each depth ``chip_smoke._llama8b_w4_part`` (the function
phase 7 calls) draws and packs that many layers under W4 + KV, runs the
generate and serve part (vanilla and speculative) and phases 8 and 9 on
those engines (default depths: 32 and ``LLAMA8B_W4_LAYERS``).

Prints one JSON line of host-clock seconds by depth (and by part of the
run) beside the card's name and power limit; exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write the JSON to this file")
    ap.add_argument("--part", choices=("w4a4", "w4"), default="w4a4", help="the part of phase 7 to time")
    ap.add_argument("--depths", type=int, nargs="+", default=None,
                    help="the depths to time (default: the full depth and the depth phase 7 runs the part at)")
    args = ap.parse_args()

    import chip_smoke as cs

    smi = cs._require_cuda()
    from repro_torch.configs import get_config

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3_1_8b")
    out = {"card": smi, "arch": "llama3_1_8b", "policy": {"w4a4": "w4a4_kv", "w4": "w4_kv"}[args.part],
           "seconds_by_depth": {}}
    if args.part == "w4a4":
        engines, _ = cs._engines(cfg, dev, policies=("w4_kv",))
        raw = engines.pop("w4_kv")._raw_params
        for n in args.depths or (cfg.num_layers, cs.LLAMA8B_W4A4_LAYERS):
            out["seconds_by_depth"][n] = cs._llama8b_w4a4_part(raw, cfg, n, dev, {})[2]
    else:
        for n in args.depths or (cfg.num_layers, cs.LLAMA8B_W4_LAYERS):
            *_, engines, secs = cs._llama8b_w4_part(cfg, n, dev, {})
            out["seconds_by_depth"][n] = secs
            del engines
            torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
