"""Serve == generate at full width on one card, and which op makes them
differ.

    python3 tools/serve_agreement.py [--src DIR] [--label NAME] [--policy w4_kv w4a4_kv]
                                     [--variant batched unembed_rows_alone prefill_rows_alone probe]

Runs ``chip_smoke.py``'s phase-4c traffic on full-width llama3_2_3b (random
weights from seed 0): ``generate`` of the 8 prompts, then ``serve`` of the
same 8 requests over 4 slots (pages of 16, max_len 256, 16 new tokens,
prefix cache on), and the share of requests whose tokens equal generate's,
with the first differing step and generate's top-2 logit gap there.  Each
variant replaces one op, in this process only, by a version whose result
for a row does not depend on the rows around it or on the padding:

  batched             the port as it is;
  unembed_rows_alone  the unembed (one matmul over the batch, whose kernel
                      cuBLAS picks by M) as one M = 1 matmul per row;
  prefill_rows_alone  prefill attention (``models/attention.py``
                      ``chunked_attention``: B 8 at the 128-token bucket in
                      generate, one request at its own bucket in serve; the
                      prefill kernel K9 since it was added, batched f32
                      matmuls before) as one call per (sequence, query) over
                      exactly the keys it attends.

If a variant's share is 1.0, the differences of ``batched`` come from that
op.  ``probe`` prefills each prompt as generate does (the 8 together) and
as serve does (alone, at its bucket), records the output of every op of
the prefill in call order (each rms_norm, qlinear and prefill attention,
and attention's q, K and V), and reports, per prompt, the first op whose
output differs between the two on the prompt's rows, bit for bit, and
whether the last logits do.
``--src`` picks the directory that holds the ``repro_torch`` package, so
that two checkouts can be run in turns within one call on one card
(parent, change, change, parent).  Prints one JSON line; exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rows_alone_unembed(x, table):
    """x @ table.T with one M = 1 matmul per row of x."""
    import torch

    w = table.to(x.dtype).T
    flat = x.reshape(-1, x.shape[-1])
    return torch.cat([flat[i:i + 1] @ w for i in range(flat.shape[0])]).reshape(*x.shape[:-1], w.shape[1])


def _rows_alone_attention(batched):
    """``chunked_attention`` one (sequence, query) at a time over exactly the
    keys a causal query at position q_offset + j attends."""
    def attend(q, k, v, *, causal=True, q_offset=0, kv_chunk=1024):
        out = q.new_empty(q.shape)
        for i in range(q.shape[0]):
            for j in range(q.shape[1]):
                n = min(q_offset + j + 1, k.shape[1]) if causal else k.shape[1]
                out[i:i + 1, j:j + 1] = batched(q[i:i + 1, j:j + 1], k[i:i + 1, :n], v[i:i + 1, :n], causal=False,
                                                kv_chunk=kv_chunk)
        return out
    return attend


def _agreement(cs, cfg, eng):
    sched_cfg, pool_cfg = cs._serve_cfgs()
    eng.serve(cs._serve_requests(cfg, 2)[:2], sched_cfg=sched_cfg, pool_cfg=pool_cfg)  # warm-up
    ref = eng.generate([r.prompt for r in cs._serve_requests(cfg, 16)], max_new_tokens=16)
    rep = eng.serve(cs._serve_requests(cfg, 16), sched_cfg=sched_cfg, pool_cfg=pool_cfg)
    share, diffs = cs._agreement(eng, rep.requests, ref)
    return {"share_equal_to_generate": share, "differs_from_generate": diffs}


def _probe(cs, cfg, eng, modules):
    """Per prompt: the first op of the prefill whose output on the prompt's
    rows differs between generate's batched prefill and serve's prefill
    alone.  ``modules``: (attention, layers, transformer), whose rms_norm,
    qlinear and chunked_attention are wrapped to record, in call order,
    (layer, op, output)."""
    import torch

    attention, layers, transformer = modules
    calls = []
    saved = []

    def wrap(mod, name, label):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def record(*a, **kw):
            out = fn(*a, **kw)
            calls.append((label, out))
            if name == "chunked_attention":
                calls.extend((f"attention {n}", t) for n, t in zip(("q", "k", "v"), a[:3]))
            return out
        setattr(mod, name, record)

    prompts = [r.prompt for r in cs._serve_requests(cfg, 16)]
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), eng._bucket(int(lens.max()), cap=eng.scfg.max_len)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    wrap(attention, "chunked_attention", "prefill attention")
    wrap(attention, "qlinear", "qlinear (q, k, v)")
    wrap(transformer, "qlinear", "qlinear wo")
    wrap(layers, "qlinear", "qlinear (gate, up, down)")
    wrap(transformer, "rms_norm", "rms_norm")
    try:
        with torch.no_grad():
            last_all, _ = eng._bucketed_prefill(toks, lens, max_len=eng.scfg.max_len, qdq_kv=eng.kv_quant)
            together = calls[:]
            result = []
            for r, p in enumerate(prompts):
                calls.clear()
                last_one, _ = eng._serve_prefill(p)
                first = None
                n = len(p)
                for i, ((label, a), (_, b)) in enumerate(zip(together, calls)):
                    x, y = a.reshape(len(prompts), -1, *a.shape[2:])[r, :n], b.reshape(1, -1, *b.shape[2:])[0, :n]
                    if not torch.equal(x, y):
                        first = {"call": i, "op": label, "max_abs_diff": float((x.float() - y.float()).abs().max())}
                        break
                result.append({"rid": r, "len": n, "calls": len(calls), "first_difference": first,
                               "last_logits_equal": bool(torch.equal(last_all[r], last_one[0]))})
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--policy", nargs="+", default=["w4_kv", "w4a4_kv"])
    ap.add_argument("--variant", nargs="+", default=["batched", "unembed_rows_alone"],
                    choices=["batched", "unembed_rows_alone", "prefill_rows_alone", "probe"])
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("serve_agreement: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import attention, layers, transformer
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3_2_3b")
    dev = torch.device("cuda", 0)
    raw = init_params(cfg, seed=0, device=dev)
    policies = cs._policies()
    engines = {name: Engine(raw, cfg, ServeConfig(max_len=128, max_new_tokens=16, quant=policies[name]), device=dev)
               for name in args.policy}
    out = {"label": args.label, "src": args.src, "card": torch.cuda.get_device_name(0)}
    unembed, chunked = transformer.unembed, attention.chunked_attention
    for variant in args.variant:
        if variant == "probe":
            out[variant] = {name: _probe(cs, cfg, eng, (attention, layers, transformer))
                            for name, eng in engines.items()}
            continue
        if variant == "unembed_rows_alone":
            transformer.unembed = _rows_alone_unembed
        if variant == "prefill_rows_alone":
            attention.chunked_attention = _rows_alone_attention(chunked)
        try:
            out[variant] = {name: _agreement(cs, cfg, eng) for name, eng in engines.items()}
        finally:
            transformer.unembed, attention.chunked_attention = unembed, chunked
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
