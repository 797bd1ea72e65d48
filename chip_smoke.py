"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printing one line (and failing the run with a traceback):
  1. device  -- the card's name and power limit (exits non-zero without CUDA);
  2. build   -- nvcc builds the three kernels from src/repro_torch/csrc/;
  3. kernels -- each kernel against its plain PyTorch version on the card at
                the full-width llama3_2_3b shapes, with times;
  4. e2e     -- full-width llama3_2_3b (random weights, packed on the card)
                through Engine.generate under the packed W4 + RaZeR-KV policy
                and the W4A4 + KV policy, with each kernel's launch count
                checked against the path's expected count, and a
                torch.profiler breakdown of one generate;
  5. parity  -- the reduced config on the card (kernels) against the CPU
                (plain versions) from the same weights.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, data sheet


def _require_cuda() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()


def _cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _counters():
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    return {"razer_matmul": razer_matmul_cuda, "razer_act_qdq": razer_act_qdq_cuda,
            "razer_kv_attention": razer_kv_attention_cuda}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def _linear_shapes(cfg):
    d, hd = cfg.d_model, cfg.hd
    return [("wq", d, cfg.num_heads * hd), ("wk", d, cfg.num_kv_heads * hd),
            ("wv", d, cfg.num_kv_heads * hd), ("wo", cfg.num_heads * hd, d),
            ("gate", d, cfg.d_ff), ("up", d, cfg.d_ff), ("down", cfg.d_ff, d)]


def _check_matmul(cfg, dev, gen, detail):
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda

    shapes = _linear_shapes(cfg)
    # four layers' worth of distinct weights (~228 MB packed) so that timing
    # cycles through more than the 50 MB L2, as a decode step does
    layers = [{name: pack_weight(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
               for name, k, n in shapes} for _ in range(4)]
    max_err = 0.0
    for name, k, n in shapes[:1] + shapes[1:2] + shapes[4:5] + shapes[6:]:  # (K, N) kinds
        pw = layers[0][name]
        for m in (4, 4 * 32):
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            got = razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                    m1=pw.sv_magnitudes[1]) * pw.tensor_scale
            want = ref.razer_matmul_ref(x, pw)
            bound = 1e-5 * (x.float().abs() @ pw.dequantize().abs()) + 1e-6
            err = (got - want).abs()
            assert bool((err <= bound).all()), f"razer_matmul K={k} N={n} M={m}: {float(err.max())}"
            max_err = max(max_err, float(err.max()))
    dense = [{name: layer[name].dequantize().to(torch.bfloat16) for name, _, _ in shapes} for layer in layers]
    out = {}
    for m in (4, 4 * 32):
        xs = {k: torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16) for _, k, _ in shapes}

        def kernel_all():
            for layer in layers:
                for name, k, _ in shapes:
                    pw = layer[name]
                    razer_matmul_cuda(xs[k], pw.codes, pw.scale_meta, m0=pw.sv_magnitudes[0],
                                      m1=pw.sv_magnitudes[1])

        def plain_layer():
            for name, k, _ in shapes:
                ref.razer_matmul_ref(xs[k], layers[0][name])

        def library_all():
            for layer in dense:
                for name, k, _ in shapes:
                    torch.matmul(xs[k], layer[name])

        nbytes = sum(m * k * 2 + k * n // 2 + k * n // 16 + m * n * 4 for _, k, n in shapes)
        flops = sum(2 * m * k * n for _, k, n in shapes)
        bound, by = _bound_ms(nbytes, flops)
        out[m] = {"ms": _cuda_ms(kernel_all, reps=10) / 4, "plain_ms": _cuda_ms(plain_layer, reps=3),
                  "library_ms": _cuda_ms(library_all, reps=10) / 4, "bound_ms": bound, "bound_by": by}
        detail[f"razer_matmul_layer_M{m}"] = out[m]
    return max_err, out[4]


def _check_act_qdq(cfg, dev, gen, detail):
    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    ks = [k for _, k, _ in _linear_shapes(cfg)]
    out = {}
    for m in (4, 4 * 32):
        xs = {k: (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16) for k in set(ks)}
        for k, x in xs.items():
            got, want = razer_act_qdq_cuda(x), ref.razer_act_qdq_ref(x)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), f"razer_act_qdq ({m}, {k}) not bit-exact"
        nbytes = sum(2 * 2 * m * k for k in ks)
        bound, by = _bound_ms(nbytes, 0.0)
        out[m] = {"ms": _cuda_ms(lambda: [razer_act_qdq_cuda(xs[k]) for k in ks]),
                  "plain_ms": _cuda_ms(lambda: [ref.razer_act_qdq_ref(xs[k]) for k in ks], reps=3),
                  "library_ms": None, "bound_ms": bound, "bound_by": by}
        detail[f"razer_act_qdq_layer_M{m}"] = out[m]
    return 0.0, out[4]


def _check_kv_attention(cfg, dev, gen, detail):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

    b, s, h, kvh, hd = 4, 128, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = torch.randn((b, h, hd), generator=gen, device=dev)
    kc, km = kv_quantize(torch.randn((b, s, kvh, hd), generator=gen, device=dev))
    vc, vm = kv_quantize(torch.randn((b, s, kvh, hd), generator=gen, device=dev))
    cur = torch.tensor([9, 40, 97, 128], dtype=torch.int32, device=dev)
    got = razer_kv_attention_cuda(q, kc, km, vc, vm, cur)
    want = ref.razer_kv_attention_ref(q, kc, km, vc, vm, cur)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)  # f32 softmax, other sum order
    err = float((got - want).abs().max())

    k, v = kv_dequantize(kc, km, hd), kv_dequantize(vc, vm, hd)
    qs = q[:, :, None, :]
    ks = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1)  # (B, H, S, hd)
    vs = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
    mask = torch.arange(s, device=dev)[None, None, None, :] < cur[:, None, None, None]

    def library():
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    valid = int(cur.sum())
    nbytes = q.numel() * 4 * 2 + valid * kvh * (hd // 2 + hd // 16) * 2 + b * 4
    flops = 4 * valid * h * hd
    bound, by = _bound_ms(nbytes, flops)
    out = {"ms": _cuda_ms(lambda: razer_kv_attention_cuda(q, kc, km, vc, vm, cur), reps=50),
           "plain_ms": _cuda_ms(lambda: ref.razer_kv_attention_ref(q, kc, km, vc, vm, cur), reps=10),
           "library_ms": _cuda_ms(library, reps=50), "bound_ms": bound, "bound_by": by}
    detail["razer_kv_attention_B4_S128"] = out
    return err, out


# ---------------------------------------------------------------------------
# phases 4 and 5
# ---------------------------------------------------------------------------
def _policies():
    from repro_torch.core.policy import QuantPolicy, TensorSpec

    w4 = QuantPolicy.packed(kv_quant=True)
    w4a4 = QuantPolicy(weight=w4.weight, act=TensorSpec.act("razer"), kv=w4.kv, rules=w4.rules)
    return {"w4_kv": w4, "w4a4_kv": w4a4}


def _full_width(dev, detail):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig, pack_model_weights

    cfg = get_config("llama3_2_3b")
    max_len, n_new = 128, 16
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (8, 15, 23, 32)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = init_params(cfg, seed=0, device=dev)
    packed = pack_model_weights(raw, cfg, _policies()["w4_kv"])
    del raw
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    results = {"pack_s": pack_s}
    layers, per_fwd = cfg.num_layers, 7 * cfg.num_layers
    for name, policy in _policies().items():
        eng = Engine(packed, cfg, ServeConfig(max_len=max_len, max_new_tokens=n_new, quant=policy), device=dev)
        toks = np.zeros((len(prompts), 32), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        last, _ = eng._bucketed_prefill(toks, np.array([len(p) for p in prompts]), max_len=max_len, qdq_kv=True)
        assert last.shape == (len(prompts), cfg.vocab_size) and bool(torch.isfinite(last.float()).all())
        for rep in range(2):  # the first run warms up, the second is timed
            _reset_counts()
            out = eng.generate(prompts)
            counts = _read_counts()
            steps = eng.stats["decode_steps"]
            want = {"razer_matmul": per_fwd * (1 + steps),
                    "razer_act_qdq": per_fwd * (1 + steps) if policy.act is not None else 0,
                    "razer_kv_attention": layers * steps}
            assert counts == want, (name, counts, want)
            assert steps == n_new - 1 and all(len(o) == len(p) + n_new for o, p in zip(out, prompts))
            assert all(0 <= t < cfg.vocab_size for o in out for t in o)
        st = eng.stats
        results[name] = {
            "prefill_ms": st["prefill_s"] * 1e3, "decode_ms_per_step": st["decode_s"] * 1e3 / steps,
            "tokens_per_s": len(prompts) * n_new / (st["prefill_s"] + st["decode_s"]),
            "launches": counts, "batch": len(prompts), "bucket": st["bucket"], "new_tokens": n_new}
    results["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    results["profile_w4a4_kv"] = _profile(eng, prompts)
    detail["e2e"] = results
    return results


def _profile(eng, prompts, new_tokens: int = 4):
    """Device time by kernel over one generate (prefill + 3 decode steps),
    from torch.profiler, and the share of the wall time the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]  # kernels, not ops
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3, "count": e.count} for e in top]}


def _card_vs_cpu(dev, detail):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    # logit tolerances of the bf16 slice tests (tests/test_torch_engine_bf16.py)
    tolerances = {"w4_kv": 0.06, "w4a4_kv": 0.25}
    cfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), num_kv_heads=2)
    params = init_params(cfg, seed=1, device="cpu")
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30]]
    lens = np.array([len(p) for p in prompts])
    toks = np.zeros((3, 16), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    out = {}
    for name, policy in _policies().items():
        scfg = ServeConfig(max_len=32, max_new_tokens=6, quant=policy)
        card, cpu = Engine(params, cfg, scfg, device=dev), Engine(params, cfg, scfg, device="cpu")
        fed = []  # the CPU run's greedy tokens, fed to both runs
        results = []
        for eng in (cpu, card):
            _reset_counts()
            last, caches = eng._bucketed_prefill(toks, lens, max_len=32, qdq_kv=True)
            caches = eng._quantize_caches(caches)
            logits, cur = [last.float().cpu()], torch.as_tensor(lens, device=eng.device)
            for step in range(5):
                if eng is cpu:
                    fed.append(torch.argmax(logits[-1], -1))
                lg, caches = eng._decode_step(fed[step].to(eng.device), caches, cur)
                logits.append(lg.float().cpu())
                cur = cur + 1
            results.append(logits)
            counts = _read_counts()
            assert (eng is card) == (counts["razer_matmul"] > 0 and counts["razer_kv_attention"] > 0), counts
            assert (eng is card and policy.act is not None) == (counts["razer_act_qdq"] > 0), counts
        diff = max(float((a - b).abs().max()) for a, b in zip(*results))
        assert diff <= tolerances[name], (name, diff)
        out[name] = {"max_abs_logit_diff": diff, "tolerance": tolerances[name]}
    detail["card_vs_cpu"] = out
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", help="also write every measured number to this JSON file")
    args = ap.parse_args()

    smi = _require_cuda()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build  # fails outside a checkout of the repo

    print(smi)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    detail = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    build_s = build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in build.build_log.items()}
    detail["build_s"], detail["ptxas"] = build_s, ptxas
    print(f"build: {build_s:.1f} s for {sorted(ptxas)}; ptxas: {json.dumps(ptxas)}")

    from repro_torch.configs import get_config

    cfg = get_config("llama3_2_3b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = {"razer_matmul": _check_matmul(cfg, dev, gen, detail),
              "razer_act_qdq": _check_act_qdq(cfg, dev, gen, detail),
              "razer_kv_attention": _check_kv_attention(cfg, dev, gen, detail)}
    print("kernels vs plain: " + json.dumps({k: {"max_abs_err": v[0], **v[1]} for k, v in checks.items()}))

    e2e = _full_width(dev, detail)
    print("e2e llama3_2_3b full width: " + json.dumps(e2e))
    parity = _card_vs_cpu(dev, detail)
    print("card vs cpu (reduced): " + json.dumps(parity))

    meta = {
        "razer_matmul": ("src/repro_torch/csrc/razer_matmul.cu", "src/repro/kernels/razer_matmul.py:112",
                         "one layer's 7 packed linears at decode M=4"),
        "razer_act_qdq": ("src/repro_torch/csrc/razer_quantize.cu", "src/repro/kernels/razer_quantize.py:103",
                          "one layer's 7 activation fake-quants at decode M=4, bf16"),
        "razer_kv_attention": ("src/repro_torch/csrc/razer_kv_attention.cu",
                               "src/repro/kernels/razer_kv_attention.py:101",
                               "B=4 H=24 KVH=8 hd=128 S=128, cur_len 9/40/97/128"),
    }
    launches = e2e["w4a4_kv"]["launches"]
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "launches": launches[name], "max_abs_err": checks[name][0],
                "ms": checks[name][1]["ms"], "plain_ms": checks[name][1]["plain_ms"],
                "bound_ms": checks[name][1]["bound_ms"], "bound_by": checks[name][1]["bound_by"],
                "library_ms": checks[name][1]["library_ms"], "work": meta[name][2]}
               for name in meta]
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"kernels": kernels, **detail}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
