"""Time the prefill-attention kernel K9 of one checkout on one card.

    python3 tools/prefill_timing.py [--src DIR] [--label NAME] [--out FILE]

Runs ``chip_smoke.py``'s phase-3 check of K9 at llama3_2_3b heads (24 / 8,
hd 128) against the ``repro_torch`` package under ``--src`` (default: this
checkout's ``src``), so that two checkouts can be timed in turns in one call
on one card (parent, change, change, parent).  Every check of that function
runs too: the plain version within PREFILL_TOL with K/V random f32, bf16
and from the KV wire format, a prompt alone at its bucket == inside the
batch of 8 at 128, and the continuation at q_offset 40, bit for bit.  Then
it holds against the plain version and times B 8 x 128, B 1 x 4096 and B 4
x 4096 with K/V random f32 and from the wire format.  Prints one JSON line:
the largest |error| over those shapes, each shape's |error|, CUDA-event time,
device time per launch (torch.profiler), plain-version time, library time
(F.scaled_dot_product_attention, bf16, causal, heads grouped) and bound;
exits non-zero without CUDA.  A package whose wrapper does not name its
kernels (``kernel_names``) is profiled under ``prefill_attention_kernel``,
the one kernel such a package has.
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
        print("prefill_timing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import prefill_attention as pa

    if not hasattr(pa, "kernel_names"):
        pa.kernel_names = lambda q_dtype: ("prefill_attention_kernel",)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    detail = {}
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    max_err, _ = cs._check_prefill_attention(get_config("llama3_2_3b"), dev, gen, detail)
    out = {"label": args.label, "src": args.src, "card": card, "max_abs_err": max_err,
           **{k: v for k, v in detail.items() if k.startswith("prefill_attention")}}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
