"""Time the port's Engine.generate at full width on one card.

    python3 tools/e2e_generate.py [--src DIR] [--label NAME]
    python3 tools/e2e_generate.py --prompt-len 1024 3968 --max-len 4096 [--new-tokens 32] [--src DIR]

Runs llama3_2_3b (all 28 layers) and dbrx_132b (its published widths, cut
to 2 of 40 layers) under the packed W4 + RaZeR-KV policy: random weights
from seed 0, 4 prompts of 8/15/23/32 tokens, max_len 128, 16 new tokens, a
warm-up generate and a timed one, then torch.profiler over one more
generate of 4 new tokens for the device time and the idle share.  ``--src``
picks the directory that holds the ``repro_torch`` package (default: this
checkout's ``src``), so that two checkouts can be timed in turns within one
call on one card (parent, change, change, parent).  Prints one JSON line;
exits non-zero without CUDA.

With ``--prompt-len LO HI`` it runs ``chip_smoke.py``'s long-context phase
instead, on full-width llama3_2_3b under W4 + KV with ServeConfig.max_len
``--max-len``: generate of 4 prompts of LO..HI random tokens and serve of 8
such requests over 4 slots, ``--new-tokens`` each, with exact launch counts,
decode ms per step, device ms, idle share, the decode-attention kernels'
share of device time and the serve == generate share.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time


def _device_profile(run):
    """(wall ms, device ms, idle share) of one run(), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
    return wall, device, 1.0 - device / wall


def _time_generate(cfg, dev):
    import numpy as np
    import torch

    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32)]
    raw = init_params(cfg, seed=0, device=dev)
    eng = Engine(raw, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=QuantPolicy.packed(kv_quant=True)),
                 device=dev)
    del raw
    for _ in range(2):  # the first run warms up, the second is timed
        out = eng.generate(prompts)
    assert all(len(o) == len(p) + 16 for o, p in zip(out, prompts))
    st = eng.stats
    wall, device, idle = _device_profile(lambda: eng.generate(prompts, max_new_tokens=4))
    result = {"prefill_ms": st["prefill_s"] * 1e3, "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
              "profile_4_new_tokens": {"wall_ms": wall, "device_ms": device, "idle_share": idle}}
    del eng
    torch.cuda.empty_cache()
    return result


def _long_context(cfg, dev, args):
    """chip_smoke.py's phase 4e on an engine of this checkout's package."""
    import torch

    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    raw = init_params(cfg, seed=0, device=dev)
    eng = Engine(raw, cfg, ServeConfig(max_len=args.max_len, max_new_tokens=args.new_tokens,
                                       quant=QuantPolicy.packed(kv_quant=True)), device=dev)
    del raw
    lo, hi = args.prompt_len
    return cs._long_context(cfg, eng, lo=lo, hi=hi, n_new=args.new_tokens)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--prompt-len", nargs=2, type=int, metavar=("LO", "HI"),
                    help="long-context mode: prompts of LO..HI random tokens")
    ap.add_argument("--max-len", type=int, default=4096, help="ServeConfig.max_len of the long-context mode")
    ap.add_argument("--new-tokens", type=int, default=32, help="new tokens per prompt in the long-context mode")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("e2e_generate: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config

    dev = torch.device("cuda", 0)
    out = {"label": args.label, "src": args.src, "card": torch.cuda.get_device_name(0)}
    if args.prompt_len:
        out["llama3_2_3b_long_context"] = _long_context(get_config("llama3_2_3b"), dev, args)
    else:
        out["llama3_2_3b"] = _time_generate(get_config("llama3_2_3b"), dev)
        out["dbrx_132b_2_layers"] = _time_generate(dataclasses.replace(get_config("dbrx_132b"), num_layers=2), dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
