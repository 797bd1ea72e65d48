"""Time the backward kernels of K9 (prefill attention) and K10 (RMSNorm) of
one checkout on one card.

    python3 tools/backward_timing.py [--src DIR] [--label NAME] [--out FILE]

Runs ``chip_smoke.py``'s phase-3 backward checks (``_check_attention_bwd``
at llama3_2_3b's heads, bf16: causal B 1 x 4096 and B 4 x 512, a window of
1024 at q_offset 512, no causal mask; then at MLA's and RecurrentGemma's
wide heads; ``_check_rms_norm_bwd`` at d 3072, M 4 and 4096) against the
``repro_torch`` package under ``--src`` (default: this checkout's ``src``),
so that two checkouts can be timed in turns in one call on one card
(parent, change, change, parent).  Every check of those
functions runs too: the gradients against autograd through the plain
versions within 2^-6 of max |want| and a repeat's bits equal.  Prints one
JSON line per run: each case's errors, CUDA-event time, device time by
kernel (torch.profiler), the plain version's and the library's backward
times and the bound; exits non-zero without CUDA.  Both checkouts need
``pab.kernel_names(dtype)`` and ``rnb.kernel_names()``.
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
        print("backward_timing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    detail = {}
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config("llama3_2_3b")
    k9_err, _, _ = cs._check_attention_bwd(cfg, dev, gen, detail)
    k10_err, _, _ = cs._check_rms_norm_bwd(cfg, dev, gen, detail)
    out = {"label": args.label, "src": args.src, "card": card, "k9_bwd_max_rel_err": k9_err,
           "k10_bwd_max_rel_err": k10_err, **detail}
    line = json.dumps(out)
    print(line)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
