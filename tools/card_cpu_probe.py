"""Where the card and the CPU first part, for the narrow models of
``chip_smoke.py``'s card-vs-CPU checks (phase 10 (d), phase 11 (c)).

    python3 tools/card_cpu_probe.py [--archs mamba2_370m recurrentgemma_2b] [--seeds 1 2 3]
                                    [--policies w4_kv w4a4_kv] [--src DIR]

For each arch, weight seed and policy it builds the narrow bf16 model as
the check does (``_zoo_narrow_cfg``, ``_narrow_inputs``), packs the same
weights on the card (the kernels) and on the CPU (the plain versions), and
runs the check's prefill and 5 teacher-forced decode steps on both, fed the
CPU run's greedy tokens.  On the way it records, in call order, the input
and output of every ``qlinear``, ``rms_norm``, the Mamba-2 / RG-LRU
prefill's convolution and scans and their decode steps, and prefill
attention.  It prints one JSON line per (arch, seed, policy): the largest
|logit| difference (the check's reading, per step), the first recorded
tensor whose bits differ between card and CPU (the op, the step, the
elements that differ, the largest difference), the first such bf16 tensor
(where an f32 difference first survives a rounding), and, under W4A4, the first
``qlinear`` input whose activation fake-quant (the plain version of K2, on
the CPU, of both inputs) differs: the codes a one-ulp difference moved.
Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _record(modules, calls):
    """Wrap each (module, name) to append (name, "in" | "outJ", tensor,
    whether it is a packed linear's input) in call order; returns the undo
    list."""
    import torch

    saved = []

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (tuple, list)):
            return [t for y in x for t in flat(y)]
        if isinstance(x, dict):
            return [t for y in x.values() for t in flat(y)]
        return []

    for mod, name in modules:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            packed = _name == "qlinear" and not isinstance(a[1], torch.Tensor)  # act-quantized under W4A4
            calls.append((_name, "in", a[0].detach().cpu(), packed))
            calls.extend((_name, f"out{j}", t.detach().cpu(), None) for j, t in enumerate(flat(out)))
            return out
        setattr(mod, name, wrapped)
    return saved


def probe(cs, arch: str, seed: int, policy_name: str) -> dict:
    import torch

    from repro_torch.core.qlinear import qdq_activation
    from repro_torch.models import attention, layers, ssm, transformer
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = cs._zoo_narrow_cfg(arch)
    params = init_params(cfg, seed=seed, device="cpu")
    prompts, extras = cs._narrow_inputs(cfg)
    policy = cs._policies()[policy_name]
    scfg = ServeConfig(max_len=32, max_new_tokens=6, quant=policy)
    wrap = [(ssm, "qlinear"), (ssm, "rms_norm"), (ssm, "_causal_conv"), (ssm, "_conv_step"), (ssm, "_ssd_chunked"),
            (ssm, "rglru_scan"), (ssm, "_rglru_gates"), (ssm, "mamba2_decode"), (ssm, "rglru_decode"),
            (transformer, "qlinear"), (transformer, "rms_norm"), (layers, "qlinear"), (attention, "qlinear"),
            (attention, "chunked_attention")]
    runs = []
    for dev in ("cpu", "cuda"):
        eng = Engine(params, cfg, scfg, device=dev)
        calls = []
        step = eng._decode_step

        def marked(*a, _step=step, _calls=calls, **kw):
            _calls.append(("decode_step", "mark", None, None))
            return _step(*a, **kw)
        eng._decode_step = marked
        saved = _record(wrap, calls)
        try:
            logits = cs._teacher_forced(eng, prompts, extras, fed=runs[0][0] if runs else None)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        runs.append((logits, calls))
        del eng
    (cpu_logits, cpu_calls), (card_logits, card_calls) = runs
    diffs = [float((a - b).abs().max()) for a, b in zip(cpu_logits, card_logits)]
    row = {"arch": arch, "seed": seed, "policy": policy_name, "max_abs_logit_diff": max(diffs), "per_step": diffs,
           "records": len(cpu_calls), "first_difference": None, "first_bf16_difference": None,
           "first_act_code_difference": None}
    assert [c[:2] for c in cpu_calls] == [c[:2] for c in card_calls], "the card and the CPU ran different ops"
    step = 0
    for i, ((name, what, a, packed), (_, _, b, _)) in enumerate(zip(cpu_calls, card_calls)):
        if what == "mark":
            step += 1
            continue
        where = {"call": i, "op": name, "tensor": what, "step": step, "shape": list(a.shape)}
        if row["first_difference"] is None and not torch.equal(a, b):
            row["first_difference"] = dict(where, elements_differ=int((a != b).sum()),
                                           max_abs_diff=float((a.float() - b.float()).abs().max()))
        if row["first_bf16_difference"] is None and a.dtype == torch.bfloat16 and not torch.equal(a, b):
            row["first_bf16_difference"] = dict(where, elements_differ=int((a != b).sum()),
                                                max_abs_diff=float((a.float() - b.float()).abs().max()))
        if policy.act is not None and packed and row["first_act_code_difference"] is None:
            qa, qb = qdq_activation(a, policy), qdq_activation(b, policy)
            if not torch.equal(qa, qb):
                row["first_act_code_difference"] = dict(
                    where, inputs_differ=int((a != b).sum()), input_max_abs_diff=float((a.float() - b.float()).abs().max()),
                    codes_differ=int((qa != qb).sum()), quantized_max_abs_diff=float((qa.float() - qb.float()).abs().max()))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archs", nargs="+", default=["mamba2_370m", "recurrentgemma_2b"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    ap.add_argument("--policies", nargs="+", default=["w4_kv", "w4a4_kv"])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ directory of the checkout to probe")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("card_cpu_probe: needs CUDA", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs

    for arch in args.archs:
        for seed in args.seeds:
            for name in args.policies:
                print(json.dumps(probe(cs, arch, seed, name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
