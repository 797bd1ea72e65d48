"""The arithmetic of K9's backward on the tensor cores, emulated on the CPU.

``csrc/prefill_attention_bwd.cu``'s tensor-core body runs only on the card.
What it rounds is emulated here in a few lines of torch and held against
the JAX package's ``jax.vjp`` of ``repro.models.attention.chunked_attention``
on the same numpy inputs (bf16 values, differentiated in f32):

* scores from bf16 q and K with f32 sums, in base 2 (scale x log2 e);
* each row's max m and sum l by an online walk over 64-key chunks, a chunk
  with no kept key leaving the row as it was; P = exp2(s - m - log2 l);
* D from dO and the forward's bf16 output O; dS = P (dP - D);
* P and dS rounded to bf16 before their products (the A operand from
  registers), each product summed in f32 one 64-wide tile at a time in the
  kernel's order: dQ over key tiles, dK and dV over the G query heads of a
  KV head and, within each, over query tiles; outputs rounded to bf16.

V may be narrower than q and k (MLA's 128 beside 192): dP, dV and D run
at V's width, and the reference pads V to q's width and slices the output
back, as ``repro.models.attention.mla_forward`` does.

Tolerance: 2^-6 of max |want| per gradient, the card tests' bf16 bound
(``tests/test_torch_cuda_train.py``).  The body's choice and the widths
the wrapper takes are checked here too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as jax_chunked_attention
from repro_torch.kernels import prefill_attention_bwd as pab
from repro_torch.kernels.ref import chunked_attention_ref

TILE = 64
TOL = 2.0 ** -6
NEG = -1e30


def _kept(sq, skv, causal, window, q_offset):
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    return keep


def emulate(q, k, v, o, dout, *, causal=True, window=0, q_offset=0, rounded=True):
    """(dq, dk, dv) in bf16 as the tensor-core body rounds them; bf16 inputs
    q, k (B, S, heads, hd), v, o, dout at V's width.  ``rounded=False``: no
    bf16 rounding anywhere, f32 outputs."""
    rnd = (lambda t: t.bfloat16().float()) if rounded else (lambda t: t)  # noqa: E731
    b, sq, h, hd = q.shape
    skv, kvh, dvw = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    scale = np.float32(1.0) / np.sqrt(np.float32(hd))
    sc = float(np.float32(scale) * np.float32(1.4426950408889634))
    heads = lambda t: t.float().permute(0, 2, 1, 3)  # noqa: E731  (b, heads, S, hd)
    qh, oh, doh = heads(q), heads(o), heads(dout)
    kh, vh = (heads(t).repeat_interleave(g, dim=1) for t in (k, v))
    s = torch.where(_kept(sq, skv, causal, window, q_offset), (qh @ kh.transpose(-1, -2)) * sc,
                    torch.tensor(NEG))
    m = torch.full((b, h, sq), NEG)
    l = torch.zeros((b, h, sq))
    for c0 in range(0, skv, TILE):
        chunk = s[..., c0:c0 + TILE]
        mn = torch.maximum(m, chunk.amax(-1))
        me = torch.where(mn == NEG, torch.tensor(0.0), mn)
        l = l * torch.exp2(m - mn) + torch.exp2(chunk - me[..., None]).sum(-1)
        m = mn
    lse = torch.where(l > 0, m + torch.log2(l), torch.tensor(0.0))
    p = torch.exp2(s - lse[..., None])
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (doh * oh).sum(-1)[..., None])
    p16, ds16 = rnd(p), rnd(ds)
    dq = torch.zeros((b, h, sq, hd))
    for c0 in range(0, skv, TILE):
        dq = dq + ds16[..., c0:c0 + TILE] @ kh[:, :, c0:c0 + TILE]
    grouped = lambda t: t.reshape(b, kvh, g, *t.shape[2:])  # noqa: E731
    p16, ds16, qg, dog = grouped(p16), grouped(ds16), grouped(qh), grouped(doh)
    dk = torch.zeros((b, kvh, skv, hd))
    dv = torch.zeros((b, kvh, skv, dvw))
    for gi in range(g):
        for t0 in range(0, sq, TILE):
            rows = slice(t0, t0 + TILE)
            dv = dv + p16[:, :, gi, rows].transpose(-1, -2) @ dog[:, :, gi, rows]
            dk = dk + ds16[:, :, gi, rows].transpose(-1, -2) @ qg[:, :, gi, rows]
    back = lambda t: t.permute(0, 2, 1, 3).to(torch.bfloat16 if rounded else torch.float32)  # noqa: E731
    return back(dq * scale), back(dk * scale), back(dv)


def _jax_grads(q, k, v, dout, **mask):
    """jax.vjp of the JAX package's chunked_attention in f32 at the bf16
    values; a V narrower than q is padded to q's width and the output
    sliced back, as the reference's MLA does."""
    f32 = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    hd, dvw = q.shape[-1], v.shape[-1]

    def attend(a, b_, c):
        c = jnp.pad(c, ((0, 0), (0, 0), (0, 0), (0, hd - dvw)))
        return jax_chunked_attention(a, b_, c, **mask)[..., :dvw]

    _, vjp = jax.vjp(attend, f32(q), f32(k), f32(v))
    return [np.asarray(x) for x in vjp(f32(dout))]


CASES = [  # (B, Sq, Skv, H, KVH, hd[, dv]), mask
    ((1, 77, 77, 3, 1, 16), dict()),
    ((2, 70, 70, 2, 2, 64), dict(causal=False)),
    ((1, 130, 130, 6, 2, 128), dict(window=40)),
    ((1, 90, 150, 3, 3, 64), dict(q_offset=60)),
    ((1, 100, 164, 6, 2, 128), dict(q_offset=64, window=50)),
    ((1, 65, 65, 4, 4, 16), dict(causal=False, window=30)),
    ((1, 100, 100, 2, 2, 192, 128), dict()),  # MLA: q/k 192, V 128
    ((1, 70, 134, 2, 1, 192, 128), dict(q_offset=64)),
    ((1, 130, 130, 3, 1, 256, 256), dict(window=40)),  # RecurrentGemma's width, MQA
    ((1, 96, 160, 2, 1, 256, 256), dict(q_offset=64, window=50)),
]


@pytest.mark.parametrize("shape,mask", CASES, ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else
                         "-".join(f"{k}{v}" for k, v in c.items()) or "causal")
def test_tensor_core_arithmetic_matches_jax_vjp(shape, mask):
    b, sq, skv, h, kvh, hd, *dvw = shape
    dvw = dvw[0] if dvw else hd
    rng = np.random.default_rng(sum(shape))
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()  # noqa: E731
    q, k, v, dout = bf(b, sq, h, hd), bf(b, skv, kvh, hd), bf(b, skv, kvh, dvw), bf(b, sq, h, dvw)
    o = chunked_attention_ref(q, k, v, **mask)  # the forward's bf16 output
    got = emulate(q, k, v, o, dout, **mask)
    want = _jax_grads(q, k, v, dout, **mask)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == torch.bfloat16 and tuple(gt.shape) == wt.shape, name
        err = float(np.abs(gt.float().numpy() - wt).max())
        scale = float(np.abs(wt).max())
        assert err <= TOL * scale, (name, err, scale)


def test_unrounded_emulation_is_the_gradient():
    """Without the bf16 roundings of P, dS and the outputs, the emulation's
    walk (base-2 statistics over 64-key chunks, the tile order) is the
    gradient to f32 accuracy: what the tolerance above absorbs is the
    rounding, not the algorithm."""
    rng = np.random.default_rng(7)
    shape = (1, 100, 130, 6, 2, 64)
    b, sq, skv, h, kvh, hd = shape
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()  # noqa: E731
    q, k, v, dout = bf(b, sq, h, hd), bf(b, skv, kvh, hd), bf(b, skv, kvh, hd), bf(b, sq, h, hd)
    mask = dict(q_offset=30, window=60)
    want = _jax_grads(q, k, v, dout, **mask)
    o = torch.from_numpy(np.array(jax_chunked_attention(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                                          **mask)))
    got = emulate(q, k, v, o, dout, rounded=False, **mask)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert float(np.abs(gt.numpy() - wt).max()) <= 1e-5 * float(np.abs(wt).max()), name


@pytest.mark.parametrize("dtypes,body", [((torch.bfloat16, True), "tensor_core"), ((torch.bfloat16, False), "f32"),
                                         ((torch.float32, True), "f32"), ((torch.float32, False), "f32")],
                         ids=["bf16", "bf16_q_f32_kv", "f32_q_bf16_kv", "f32"])
def test_body_is_chosen_by_dtype(dtypes, body):
    assert pab.kernel_body(*dtypes) == body
    names = pab.kernel_names(*dtypes)
    assert len(names) == 2 and all(n.startswith("prefill_attention_bwd_") for n in names)
    assert ("_tc_" in names[0]) == (body == "tensor_core")


@pytest.mark.parametrize("hd,dv", [(192, 192), (256, 128), (48, 48), (128, 64)])
def test_refuses_other_widths(hd, dv):
    q = torch.zeros((1, 4, 2, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, hd), dtype=torch.bfloat16)
    v = torch.zeros((1, 4, 1, dv), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        pab.check_args(q, k, v)


@pytest.mark.parametrize("hd,dv", [(16, 16), (128, 128), (192, 128), (256, 256)])
def test_takes_the_forward_widths(hd, dv):
    q = torch.zeros((1, 4, 2, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, hd), dtype=torch.bfloat16)
    pab.check_args(q, k, torch.zeros((1, 4, 1, dv), dtype=torch.bfloat16))


def test_wrapper_wants_o_and_dout_at_v_width():
    """At MLA's widths o and dout have V's 128, not q's 192: a dout at q's
    width raises before anything reaches the card."""
    q = torch.zeros((1, 4, 2, 192), dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 2, 192), dtype=torch.bfloat16)
    v = torch.zeros((1, 4, 2, 128), dtype=torch.bfloat16)
    o = torch.zeros((1, 4, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="V's width"):
        pab.prefill_attention_bwd_cuda(q, k, v, o, torch.zeros((1, 4, 2, 192), dtype=torch.bfloat16))

