"""Time the decode-attention kernels K3, K4, K5 and the activation quantizer
K2 of one checkout on one card.

    python3 tools/attention_timing.py [--src DIR] [--label NAME] [--out FILE]

Runs ``chip_smoke.py``'s phase-3 checks of K2 (one llama3_2_3b layer's 7
activation fake-quants at M = 4), K3, K4 and K5 (B 4 at lengths 9/40/97/128,
T = 3 for K5) and its long shapes (B 16 at 4096 with one sequence at 4001,
B 1 at 32768) against the ``repro_torch`` package under ``--src`` (default:
this checkout's ``src``), so that two checkouts can be timed in turns in one
call on one card (parent, change, change, parent).  Every check of those
functions runs too (plain versions within 1e-4, K4 == K3, K5 == K4,
batch invariance).  Prints one JSON line: each kernel's CUDA-event time,
device time per launch (torch.profiler), plain-version time, library time
(F.scaled_dot_product_attention in f32 and bf16) and bound; exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("attention_timing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = get_config("llama3_2_3b")
    detail = {}
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    short = {"razer_act_qdq": cs._check_act_qdq(cfg, dev, gen, detail)[1],
             "razer_kv_attention": cs._check_kv_attention(cfg, dev, gen, detail)[1],
             **{k: v[1] for k, v in cs._check_paged_attention(cfg, dev, gen, detail).items()}}
    out = {"label": args.label, "src": args.src, "card": card, "short": short,
           "long": cs._check_attention_long(cfg, dev, gen, detail)}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
