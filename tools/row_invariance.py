"""Which ops of a prefill give a row different bits when the rows around it
change, at full-width llama3_2_3b shapes on one card.

    python3 tools/row_invariance.py [--src DIR] [--label NAME] [--seed N]

``generate`` prefills 8 prompts together at the 128-token bucket; ``serve``
prefills each prompt alone at its own bucket (8, 16, 32 ... 128 for the
8..100-token prompts of ``chip_smoke.py`` phase 4c).  For each op on that
path this script computes the op once on the batch (B 8 x 128 rows, M = 1024
for a linear) and once per prompt alone at its bucket, from the same inputs
(random, seed ``--seed``), and reports, per op, the prompts whose valid rows
differ bit for bit and the largest difference:

  rms_norm          ``models/layers.py::rms_norm`` over d_model;
  silu_mul          SwiGLU's ``g * sigmoid(g) * u``;
  rope              ``apply_rope`` on q;
  act_qdq           the activation fake-quant (K2) on d_model rows;
  matmul            the packed GEMM (K1) on bf16 rows, with no activation
                    quant and with it (``act_svs``), for wq and down;
  prefill_attention ``models/attention.py::chunked_attention`` (causal);
  unembed           x @ table.T;

and then at decode's row counts: generate decodes the 8 prompts together
(8 rows), serve over 4 slots (4 rows), a prompt alone 1 row
(``decode_*``: rms_norm, the activation fake-quant, the W4A4 GEMM for wq
and down, the unembed; rows of 8 against the same rows of 4 and of 1).
An op that is row-invariant lists no prompt.  ``--src`` picks the directory
that holds the ``repro_torch`` package, so that two checkouts can be run in
turns within one call on one card.  Prints one JSON line; exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
LENS = (8, 15, 23, 32, 40, 57, 64, 100)  # chip_smoke.py phase 4c's prompts
BUCKET = 128


def _bucket(n: int) -> int:
    return max(8, 1 << (n - 1).bit_length())


def _compare(batched, alone, name, out):
    """batched: f(X) for X (8, 128, ...); alone(r, s): f(X[r:r+1, :s])."""
    import torch

    diffs = []
    for r, n in enumerate(LENS):
        a, b = batched[r, :n], alone(r, _bucket(n))[0, :n]
        if not torch.equal(a, b):
            diffs.append({"prompt": r, "len": n, "bucket": _bucket(n),
                          "max_abs_diff": float((a.float() - b.float()).abs().max())})
    out[name] = {"row_invariant": not diffs, "differs": diffs}


def _compare_decode(f, x, name, out):
    """f(x) for x (8, 1, ...) against f(x[:4]) and f(x[:1]) on their rows."""
    import torch

    whole = f(x)
    diffs = [{"rows": m, "max_abs_diff": float((whole[:m].float() - f(x[:m].contiguous()).float()).abs().max())}
             for m in (4, 1) if not torch.equal(whole[:m], f(x[:m].contiguous()))]
    out[f"decode_{name}"] = {"row_invariant": not diffs, "differs": diffs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("row_invariance: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels import ops
    from repro_torch.models import attention, layers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3_2_3b")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    bf = torch.bfloat16
    d, f, h, kvh, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    rnd = lambda *shape, s=1.0: (torch.randn(shape, generator=g, device=dev) * s).to(bf)  # noqa: E731
    out = {"label": args.label, "src": args.src, "card": torch.cuda.get_device_name(0), "prompt_lens": LENS}

    x, gamma = rnd(8, BUCKET, d, s=3.0), torch.randn(d, generator=g, device=dev) * 0.1
    _compare(layers.rms_norm(x, gamma, cfg.norm_eps), lambda r, s: layers.rms_norm(x[r:r + 1, :s], gamma,
                                                                                      cfg.norm_eps),
             "rms_norm", out)
    gt, up = rnd(8, BUCKET, f), rnd(8, BUCKET, f)
    silu_mul = lambda a, b: a * torch.sigmoid(a) * b  # noqa: E731
    _compare(silu_mul(gt, up), lambda r, s: silu_mul(gt[r:r + 1, :s], up[r:r + 1, :s]), "silu_mul", out)
    q = rnd(8, BUCKET, h, hd)
    pos = torch.arange(BUCKET, device=dev).expand(8, BUCKET)
    _compare(layers.apply_rope(q, pos, cfg.rope_theta),
             lambda r, s: layers.apply_rope(q[r:r + 1, :s], pos[:1, :s], cfg.rope_theta), "rope", out)
    _compare(ops.razer_act_qdq(x), lambda r, s: ops.razer_act_qdq(x[r:r + 1, :s].contiguous()), "act_qdq", out)

    fused = "act_svs" in inspect.signature(ops.razer_matmul).parameters
    for name, k, n in (("wq", d, h * hd), ("down", f, d)):
        pw = pack_weight(torch.randn((k, n), generator=g, device=dev) / k**0.5)
        xs = x if k == d else gt
        _compare(ops.razer_matmul(xs, pw), lambda r, s: ops.razer_matmul(xs[r:r + 1, :s].contiguous(), pw),
                 f"matmul_{name}", out)
        if fused:
            mm = lambda a: ops.razer_matmul(a, pw, act_svs=(5.0, -5.0))  # noqa: E731
        else:
            mm = lambda a: ops.razer_matmul(ops.razer_act_qdq(a), pw)  # noqa: E731
        _compare(mm(xs), lambda r, s: mm(xs[r:r + 1, :s].contiguous()), f"matmul_{name}_act_qdq", out)

    k_, v_ = rnd(8, BUCKET, kvh, hd), rnd(8, BUCKET, kvh, hd)
    for dtype in (bf, torch.float32):  # bf16 K/V, and f32 as prefill(qdq_kv=True) gives them
        kk, vv = k_.to(dtype), v_.to(dtype)
        _compare(attention.chunked_attention(q, kk, vv, causal=True),
                 lambda r, s: attention.chunked_attention(q[r:r + 1, :s], kk[r:r + 1, :s], vv[r:r + 1, :s],
                                                          causal=True),
                 f"prefill_attention_kv_{str(dtype).split('.')[-1]}", out)
    table = rnd(cfg.vocab_size, d, s=0.02)
    xl = x[:, :1]
    _compare(layers.unembed(xl.reshape(1, 8, d), table).reshape(8, 1, -1),
             lambda r, s: layers.unembed(xl[r:r + 1], table), "unembed", out)

    xd, gd = x[:, -1:].contiguous(), gt[:, -1:].contiguous()  # (8, 1, d): one decode step's rows
    _compare_decode(lambda a: layers.rms_norm(a, gamma, cfg.norm_eps), xd, "rms_norm", out)
    _compare_decode(ops.razer_act_qdq, xd, "act_qdq", out)
    for name, k, n in (("wq", d, h * hd), ("down", f, d)):
        pw = pack_weight(torch.randn((k, n), generator=g, device=dev) / k**0.5)
        a = xd if k == d else gd
        if fused:
            _compare_decode(lambda t: ops.razer_matmul(t, pw, act_svs=(5.0, -5.0)), a, f"matmul_{name}_act_qdq", out)
        else:
            _compare_decode(lambda t: ops.razer_matmul(ops.razer_act_qdq(t), pw), a, f"matmul_{name}_act_qdq", out)
    _compare_decode(lambda a: layers.unembed(a, table), xd, "unembed", out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
