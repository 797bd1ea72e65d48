"""The premises of the prefill kernel's tensor-core body (K9), on the CPU.

The card splits f32 K, V and P into bf16 parts and sums exact products in
f32; it skips the MMAs of parts that are all zero.  Here, without a card:
every value the KV wire format decodes to is exact in bf16 (so the serving
path's low parts are zero), the split's residuals are as small as the
kernel's header says, an emulation of the split arithmetic holds the
plain version's f32-K/V tolerance on the card, the body follows q's dtype
alone, and the wrapper refuses what the kernel does not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.kvcache import kv_dequantize as jax_kv_dequantize
from repro_torch.kernels import ref
from repro_torch.kernels.prefill_attention import (HEAD_DIMS, kernel_body, kernel_names, prefill_attention_cuda,
                                                   workspace_shapes)
from repro_torch.serving.kvcache import kv_dequantize, kv_quantize

torch.set_num_threads(2)

# chip_smoke.py's PREFILL_TOL for f32 K/V: the card's K9 against its plain version
F32_KV_TOL = dict(rtol=2**-7, atol=1e-6)


def split_bf16(x: torch.Tensor, parts: int = 3) -> list:
    """f32 ``x`` as ``parts`` bf16 parts (as f32 tensors), the split of
    ``csrc/prefill_attention.cu``: each part is the bf16 rounding of what
    the earlier ones leave, and every difference is exact in f32."""
    out, rest = [], x.to(torch.float32)
    for _ in range(parts):
        part = rest.to(torch.bfloat16).to(torch.float32)
        out.append(part)
        rest = rest - part
    return out


def _wire_rows():
    """Every meta byte (SV sign << 7 | E4M3 scale code) with every FP4 code:
    256 rows of hd 16, row m holding codes 0 .. 15 under meta byte m."""
    nib = np.arange(16, dtype=np.uint8)
    codes = np.tile((nib[0::2] | (nib[1::2] << 4))[None, :], (256, 1))  # low nibble first
    meta = np.arange(256, dtype=np.uint8)[:, None]
    return codes, meta


def test_every_wire_value_is_exact_in_bf16():
    """16 codes x 128 scale codes x both SV signs: each decoded value (the
    port's and the JAX package's, which agree bit for bit) is a bf16, so its
    mid and lo parts are zero and the card skips their MMAs."""
    codes, meta = _wire_rows()
    got = kv_dequantize(torch.from_numpy(codes), torch.from_numpy(meta), 16)
    want = np.asarray(jax_kv_dequantize(jnp.asarray(codes), jnp.asarray(meta), 16))
    assert got.dtype == torch.float32 and got.shape == (256, 16)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert torch.isfinite(got).all()
    assert torch.equal(got.to(torch.bfloat16).float(), got)
    assert (got.view(torch.int32) & 0xFFFF == 0).all()  # the kernel's vote: the low half of every f32 is zero
    hi, mid, lo = split_bf16(got)
    assert torch.equal(hi, got) and not mid.any() and not lo.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_quantize_roundtrip_is_exact_in_bf16(seed):
    """What prefill's ``_qdq_kv`` hands the kernel, from random activations
    at several magnitudes (the serving path's K/V): exact in bf16."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((3, 37, 2, 64)) * 10.0 ** rng.uniform(-3, 3, (3, 37, 2, 1)))
                         .astype(np.float32))
    y = kv_dequantize(*kv_quantize(x), 64)
    assert torch.equal(y.to(torch.bfloat16).float(), y)


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e6])
def test_split_residuals(scale):
    """Random f32 values: each part is a bf16, the parts and what is left
    sum to the value exactly; two parts leave below 2^-16 of it, three below
    2^-24 (the header's bounds; two do not hold the card's tolerance)."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = torch.from_numpy((rng.standard_normal(20000) * scale).astype(np.float32))
    parts = split_bf16(x, 3)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    x64 = x.double()
    two = x64 - parts[0].double() - parts[1].double()
    three = two - parts[2].double()
    assert (two.abs() <= 2.0**-16 * x64.abs()).all()
    assert (three.abs() <= 2.0**-24 * x64.abs()).all()
    assert torch.equal((x - parts[0]) - parts[1] - parts[2], three.float())  # each difference exact in f32


def _f32(t):
    return t.float().double()


def _emulate(q, k, v, parts: int, chunk: int = 64):
    """The tensor-core body's arithmetic, emulated: K, V and P split into
    ``parts`` bf16 parts (P rounded to bf16 for bf16 V), the part products
    (exact) summed per 16-deep k-step in f64 and rounded to f32 after each,
    base-2 exponentials of scores scaled by scale x log2 e, the chunk walk
    of 64 keys, each chunk's P V summed from zero and added to the output
    as acc alpha + chunk with one rounding (the kernel's fma).  -> (B, Sq,
    H, hd) bf16."""
    b, s, h, hd = q.shape
    kvh, g = k.shape[2], h // k.shape[2]
    qd = q.double().reshape(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)
    kp = [t.double().permute(0, 2, 1, 3) for t in split_bf16(k, parts)]
    vp = [t.double().permute(0, 2, 1, 3) for t in split_bf16(v, parts)]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    sc = float(np.float32(scale) * np.float32(1.4426950408889634))
    m = torch.full((b, kvh, g, s), -1e30, dtype=torch.float64)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, g, s, hd), dtype=torch.float64)
    qpos = torch.arange(s)
    for c0 in range(0, s, chunk):
        w = min(chunk, s - c0)
        sco = torch.zeros((b, kvh, g, s, w), dtype=torch.float64)
        for d0 in range(0, hd, 16):
            for part in kp:
                sco = _f32(sco + qd[..., d0:d0 + 16] @ part[:, :, None, c0:c0 + w, d0:d0 + 16].transpose(-1, -2))
        sco = _f32(sco * sc)
        sco = torch.where((c0 + torch.arange(w))[None, :] <= qpos[:, None], sco, torch.full_like(sco, -1e30))
        mn = torch.maximum(m, sco.amax(-1))
        p = _f32(torch.exp2(_f32(sco - mn[..., None])))
        al = _f32(torch.exp2(_f32(m - mn)))
        l = _f32(_f32(l * al) + _f32(p.sum(-1)))
        pp = [p.float().to(torch.bfloat16).double()] if v.dtype == torch.bfloat16 else split_bf16(p.float(), parts)
        pv_sum = torch.zeros_like(acc)
        for j0 in range(0, w, 16):
            for pi, pv in enumerate(pp):
                for vi, vv in enumerate(vp):
                    if pi + vi < parts:
                        pv_sum = _f32(pv_sum + pv.double()[..., j0:j0 + 16] @ vv[:, :, None, c0 + j0:c0 + j0 + 16, :])
        acc = _f32(acc * al[..., None] + pv_sum)
        m = mn
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(torch.bfloat16)


@pytest.mark.parametrize("kv", ["wire", "f32"])
@pytest.mark.parametrize("g,hd", [(3, 64), (1, 128)])
def test_split_arithmetic_holds_the_f32_kv_tolerance(kv, g, hd):
    """The emulated three-part arithmetic against the plain version within
    the card's f32-K/V tolerance, with K/V from the wire format (the serving
    path's) and random f32 (every part non-zero)."""
    rng = np.random.default_rng(hd + g)
    b, s, kvh = 2, 100, 2
    q = torch.from_numpy(rng.standard_normal((b, s, g * kvh, hd)).astype(np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kvh, hd)).astype(np.float32)) for _ in range(2))
    if kv == "wire":
        k, v = (kv_dequantize(*kv_quantize(t), hd) for t in (k, v))
    got = _emulate(q, k, v, parts=3)
    want = ref.chunked_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **F32_KV_TOL)


@pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "tensor_core"), (torch.float32, "f32")])
def test_body_follows_q_dtype_alone(dtype, body):
    """A bf16 q runs the tensor-core body (the split, then the attention), an
    f32 q the f32 body; nothing else enters the choice."""
    assert kernel_body(dtype) == body
    assert kernel_names(dtype) == ({"tensor_core": ("prefill_attention_tc_split_kernel", "prefill_attention_tc_kernel"),
                                    "f32": ("prefill_attention_f32_kernel",)}[body])


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_body_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="bf16 or f32"):
        kernel_body(dtype)


def test_workspace_shapes():
    """Six bf16 64 x hd tiles and one flag per (b, kv head, 64-key chunk)."""
    assert workspace_shapes(2, 130, 8, 128) == ((2 * 8 * 3 * 6 * 64 * 128 * 2,), (2 * 8 * 3,))
    assert workspace_shapes(1, 64, 1, 16) == ((6 * 64 * 16 * 2,), (1,))


def _args(dtype=torch.bfloat16, hd=64, h=6, kvh=2, kv_dtype=torch.float32):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 9, h, hd)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((1, 9, kvh, hd)).astype(np.float32)).to(kv_dtype) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case,match", [
    (dict(), "CUDA tensors"),
    (dict(dtype=torch.float32), "CUDA tensors"),
    (dict(dtype=torch.float16), "bf16/f32"),
    (dict(kv_dtype=torch.float16), "bf16/f32"),
    (dict(hd=48), "unsupported heads"),
    (dict(hd=256), "unsupported heads"),
    (dict(h=5, kvh=2), "unsupported heads"),
])
def test_wrapper_refuses(case, match):
    """The wrapper's checks, on CPU tensors: the shapes and dtypes the kernel
    does not take are refused first; valid CPU tensors are refused as not
    CUDA (``kernels.ops.prefill_attention`` routes them to the plain
    version)."""
    with pytest.raises(ValueError, match=match):
        prefill_attention_cuda(*_args(**case))


def test_wrapper_refuses_a_negative_offset_and_mismatched_shapes():
    q, k, v = _args()
    with pytest.raises(ValueError, match="q_offset"):
        prefill_attention_cuda(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="do not match"):
        prefill_attention_cuda(q, k, v[:, :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        prefill_attention_cuda(q, k.transpose(1, 2), v)
    assert 64 in HEAD_DIMS and 48 not in HEAD_DIMS
