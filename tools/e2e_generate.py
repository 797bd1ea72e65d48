"""Time the port's Engine.generate at full width on one card.

    python3 tools/e2e_generate.py [--src DIR] [--label NAME] [--policy w4_kv|w4a4_kv] [--llama-only]
                                  [--repeat N] [--serve-k K] [--fuse-act-max-m M]
    python3 tools/e2e_generate.py --prompt-len 1024 3968 --max-len 4096 [--new-tokens 32] [--src DIR]

Runs llama3_2_3b (all 28 layers) and dbrx_132b (its published widths, cut
to 2 of 40 layers) under the packed W4 + RaZeR-KV policy (``--policy
w4a4_kv``: W4A4 + KV): random weights from seed 0, 4 prompts of 8/15/23/32
tokens, max_len 128, 16 new tokens, a warm-up generate and a timed one, then
torch.profiler over one more generate of 4 new tokens for the device time
and the idle share, and per decode step the difference between profiles of
a generate of 5 new tokens and one of 1, over 4 steps (device ms, wall ms,
idle share and kernel launches per step).  ``--src``
picks the directory that holds the ``repro_torch`` package (default: this
checkout's ``src``), so that two checkouts can be timed in turns within one
call on one card (parent, change, change, parent).  ``--repeat N`` times N
generates after the warm-up (``decode_ms_per_step_runs``, ``prefill_ms_runs``;
the first is also the single reading).  ``--serve-k K`` then serves llama
``chip_smoke.py`` phase 4c's traffic (8 requests over 4 slots, pages of 16,
16 new tokens) with ``speculate_k=K`` and a bf16 draft, ``--repeat`` times
after a warm-up: tokens/s, wall s, verify and draft ms per iteration, and
torch.profiler's wall ms, device ms and idle share of one more serve.
``--fuse-act-max-m M`` sets the package's ``FUSE_ACT_MAX_M`` (the largest M
whose W4A4 GEMM fake-quantizes x in its own load) before anything runs, to
time that choice; a package without it is refused.  Prints one JSON line;
exits non-zero without CUDA.

With ``--prompt-len LO HI`` it runs ``chip_smoke.py``'s long-context phase
instead, on full-width llama3_2_3b under W4 + KV with ServeConfig.max_len
``--max-len``: generate of 4 prompts of LO..HI random tokens and serve of 8
such requests over 4 slots, ``--new-tokens`` each, with exact launch counts,
decode ms per step, device ms, idle share, the decode-attention kernels'
share of device time and the serve == generate share.  That mode counts the
launches of this checkout's ``chip_smoke.py``, so ``--src`` must name a
package with the same kernels.
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


def _policy(name):
    from repro_torch.core.policy import QuantPolicy, TensorSpec

    w4 = QuantPolicy.packed(kv_quant=True)
    if name == "w4_kv":
        return w4
    return QuantPolicy(weight=w4.weight, act=TensorSpec.act("razer"), kv=w4.kv, rules=w4.rules)


def _launches(run):
    """Device kernels launched by one run(), from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def _time_serve(cfg, eng, k, repeat):
    """Phase 4c's serve traffic on ``eng`` with speculate_k ``k`` and a bf16
    draft (vanilla at k 0): ``repeat`` timed runs after a warm-up, then one
    under the profiler."""
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.obs import Tracer

    sched_cfg, pool_cfg = cs._serve_cfgs()
    draft = "bf16" if k else None

    def serve(trace=None):
        return eng.serve(cs._serve_requests(cfg, 16), sched_cfg=sched_cfg, pool_cfg=pool_cfg, speculate_k=k,
                         draft_policy=draft, trace=trace)

    serve()  # warm-up
    runs = []
    for _ in range(repeat):
        tracer = Tracer()
        rep = serve(tracer)
        row = {"tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_time, "accept_rate": rep.accept_rate,
               "decode_steps": rep.decode_steps}
        if k:
            row.update(verify_ms_per_iteration=cs._span_ms(tracer, "verify"),
                       draft_ms_per_iteration=cs._span_ms(tracer, "draft"))
        else:
            row["decode_ms_per_step"] = cs._span_ms(tracer, "decode_step")
        runs.append(row)
    wall, device, idle = _device_profile(serve)
    eng._spec_cache.clear()
    return {"speculate_k": k, "runs": runs, "profile": {"wall_ms": wall, "device_ms": device, "idle_share": idle}}


def _time_generate(cfg, dev, policy="w4_kv", repeat=1, serve_k=None):
    import numpy as np
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32)]
    raw = init_params(cfg, seed=0, device=dev)
    eng = Engine(raw, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=_policy(policy)), device=dev)
    del raw
    out = eng.generate(prompts)  # warm-up
    decode, prefill = [], []
    for i in range(repeat):
        out = eng.generate(prompts)
        if i == 0:
            st = dict(eng.stats)
        decode.append(eng.stats["decode_s"] * 1e3 / eng.stats["decode_steps"])
        prefill.append(eng.stats["prefill_s"] * 1e3)
    assert all(len(o) == len(p) + 16 for o, p in zip(out, prompts))
    wall, device, idle = _device_profile(lambda: eng.generate(prompts, max_new_tokens=4))
    one, five = (_device_profile(lambda: eng.generate(prompts, max_new_tokens=n)) for n in (1, 5))
    step_wall, step_device = (five[0] - one[0]) / 4, (five[1] - one[1]) / 4
    step_launches = (_launches(lambda: eng.generate(prompts, max_new_tokens=5))
                     - _launches(lambda: eng.generate(prompts, max_new_tokens=1))) / 4
    result = {"policy": policy, "prefill_ms": st["prefill_s"] * 1e3,
              "decode_ms_per_step": st["decode_s"] * 1e3 / st["decode_steps"],
              "decode_ms_per_step_runs": decode, "prefill_ms_runs": prefill,
              "profile_4_new_tokens": {"wall_ms": wall, "device_ms": device, "idle_share": idle},
              "profile_decode_per_step": {"wall_ms": step_wall, "device_ms": step_device,
                                          "idle_share": 1.0 - step_device / step_wall,
                                          "kernel_launches": step_launches}}
    if serve_k is not None:
        result["serve"] = _time_serve(cfg, eng, serve_k, repeat)
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
    ap.add_argument("--policy", default="w4_kv", choices=["w4_kv", "w4a4_kv"], help="the short mode's policy")
    ap.add_argument("--llama-only", action="store_true", help="the short mode without dbrx_132b")
    ap.add_argument("--repeat", type=int, default=1, help="timed generates (and serves) after the warm-up")
    ap.add_argument("--serve-k", type=int, help="the short mode also serves llama with this speculate_k")
    ap.add_argument("--fuse-act-max-m", type=int, help="set the package's FUSE_ACT_MAX_M first")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if args.fuse_act_max_m is not None:
        from repro_torch.kernels import razer_matmul

        if not hasattr(razer_matmul, "FUSE_ACT_MAX_M"):
            ap.error(f"{args.src}'s package has no FUSE_ACT_MAX_M")
        razer_matmul.FUSE_ACT_MAX_M = args.fuse_act_max_m

    if not torch.cuda.is_available():
        print("e2e_generate: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config

    dev = torch.device("cuda", 0)
    out = {"label": args.label, "src": args.src, "card": torch.cuda.get_device_name(0),
           "fuse_act_max_m": args.fuse_act_max_m}
    if args.prompt_len:
        out["llama3_2_3b_long_context"] = _long_context(get_config("llama3_2_3b"), dev, args)
    else:
        out["llama3_2_3b"] = _time_generate(get_config("llama3_2_3b"), dev, args.policy, args.repeat, args.serve_k)
        if not args.llama_only:
            out["dbrx_132b_2_layers"] = _time_generate(dataclasses.replace(get_config("dbrx_132b"), num_layers=2),
                                                       dev, args.policy, args.repeat)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
