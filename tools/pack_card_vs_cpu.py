#!/usr/bin/env python3
"""Pack the same float32 weights with ``pack_weight`` on the card and on the
CPU and compare the wire bytes: the tensor scale, the codes and the
scale/meta bytes, and where they differ, the op that moves first.

    python tools/pack_card_vs_cpu.py [--shapes 512x384 4096x4096] [--seeds 0 1 2] [--src DIR]

The weights are drawn on the CPU from a seeded generator and copied to the
card, so both packings start from the same bits.  Prints one JSON line per
(shape, seed) and a summary line; needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch


def _bits(t: torch.Tensor) -> int:
    return int(t.detach().cpu().reshape(1).view(torch.int32)[0])


def compare(k: int, n: int, seed: int) -> dict:
    from repro_torch.core.formats import FP4_MAX, positive_format_values
    from repro_torch.core.packing import pack_weight

    g = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=g) * 0.02
    card, cpu = pack_weight(w.cuda()), pack_weight(w)
    grid_max = float(positive_format_values("e3m3")[-1])
    amax_card, amax_cpu = w.cuda().abs().amax(), w.abs().amax()
    row = {"shape": [k, n], "seed": seed,
           "tensor_scale_bits": [_bits(card.tensor_scale), _bits(cpu.tensor_scale)],
           "codes_differ": int((card.codes.cpu() != cpu.codes).sum()),
           "scale_meta_differ": int((card.scale_meta.cpu() != cpu.scale_meta).sum()),
           "amax_equal": bool(amax_card.cpu() == amax_cpu),
           # the default tensor scale, amax / (grid max * 6), with a Python
           # scalar divisor (as razer_quantize computes it) and with the
           # divisor as a tensor on the same device
           "scalar_divisor_bits": [_bits(amax_card / (grid_max * FP4_MAX)), _bits(amax_cpu / (grid_max * FP4_MAX))],
           "tensor_divisor_bits": [_bits(amax_card / torch.tensor(grid_max * FP4_MAX, device="cuda")),
                                   _bits(amax_cpu / torch.tensor(grid_max * FP4_MAX))],
           "numpy_float32_bits": int(np.array(np.float32(amax_cpu.item()) / np.float32(grid_max * FP4_MAX),
                                              np.float32).view(np.int32))}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shapes", nargs="+", default=["512x384", "4096x4096", "14336x4096"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parent.parent / "src"),
                    help="the src/ directory of the checkout to measure (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    if not torch.cuda.is_available():
        print("needs CUDA")
        return 2
    rows = []
    for shape in args.shapes:
        k, n = (int(v) for v in shape.split("x"))
        for seed in args.seeds:
            rows.append(compare(k, n, seed))
            print(json.dumps(rows[-1]))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "src": args.src, "cases": len(rows),
                      "bytes_differ": sum(r["codes_differ"] + r["scale_meta_differ"] > 0 for r in rows),
                      "tensor_scale_differs": sum(r["tensor_scale_bits"][0] != r["tensor_scale_bits"][1]
                                                  for r in rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
