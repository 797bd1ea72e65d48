"""The prefill kernel K9 at the shapes of MLA (head width 192, V at 128) and
of whisper (no causal mask: the encoder's self-attention, and the decoder's
cross-attention to 1500 frames), on a card, against its plain version, and
the row invariance the serving invariants rest on.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_zoo.py
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.prefill_attention import prefill_attention_cuda

# against the plain version: with bf16 V, two bf16 ulps of the output plus
# 2^-9 (P is rounded to bf16 in both, and an f32 ulp of p can move that
# rounding); with f32 V, one bf16 ulp and 1e-6 for a bf16 q, 1e-5 for an
# f32 q
BF16_V_TOL = dict(rtol=2**-7, atol=2**-9)
F32_V_TOL = dict(rtol=2**-7, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the CPU the plain versions are tested")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b, sq, skv, h, kvh, hd, dv, q_dtype, kv_dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device=device).to(q_dtype)
    k = torch.randn((b, skv, kvh, hd), generator=g, device=device).to(kv_dtype)
    v = torch.randn((b, skv, kvh, dv), generator=g, device=device).to(kv_dtype)
    return q, k, v


def _tol(q_dtype, v_dtype):
    if v_dtype == torch.bfloat16:
        return BF16_V_TOL
    return F32_TOL if q_dtype == torch.float32 else F32_V_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,q_offset", [(70, 0), (37, 40)])
def test_cuda_mla_width_matches_plain(cuda_device, q_dtype, kv_dtype, sq, q_offset):
    """hd 192 with V at 128 (MLA), causal, one query head per KV head."""
    q, k, v = _inputs(cuda_device, 2, sq, sq + q_offset, 4, 4, 192, 128, q_dtype, kv_dtype, seed=sq + q_offset)
    got = prefill_attention_cuda(q, k, v, causal=True, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    assert got.shape == (2, sq, 4, 128) and got.dtype == q_dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(q_dtype, kv_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_mla_width_rows_alone_equal_batched(cuda_device, q_dtype):
    """At hd 192 a prompt's rows alone at its bucket equal its rows inside a
    batch of 4 at the 32-token bucket (the generate bucket), bit for bit."""
    q, k, v = _inputs(cuda_device, 4, 32, 32, 8, 8, 192, 128, q_dtype, torch.bfloat16, seed=3)
    batched = prefill_attention_cuda(q, k, v)
    for r, n in enumerate((8, 15, 23, 32)):
        s = max(8, 1 << (n - 1).bit_length())
        alone = prefill_attention_cuda(*(t[r:r + 1, :s].contiguous() for t in (q, k, v)))
        assert torch.equal(alone[0, :n], batched[r, :n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq", [1, 8, 32, 1500])
def test_cuda_non_causal_matches_plain(cuda_device, q_dtype, sq):
    """Whisper's shapes without the causal mask: the encoder's 1500 frames
    attending each other, and 1 to 32 decoder queries against the 1500
    encoder frames (8 heads of 64)."""
    q, k, v = _inputs(cuda_device, 1, sq, 1500, 8, 8, 64, 64, q_dtype, torch.bfloat16, seed=sq)
    got = prefill_attention_cuda(q, k, v, causal=False)
    want = ref.chunked_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **_tol(q_dtype, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_non_causal_query_alone_equals_batched(cuda_device, q_dtype):
    """Without the mask a query's bits do not depend on the queries beside
    it: one query alone (a decode step's cross-attention) equals its row
    among 32 (the prefill's), bit for bit."""
    q, k, v = _inputs(cuda_device, 1, 32, 1500, 8, 8, 64, 64, q_dtype, torch.bfloat16, seed=11)
    batched = prefill_attention_cuda(q, k, v, causal=False)
    for i in (0, 7, 31):
        alone = prefill_attention_cuda(q[:, i:i + 1].contiguous(), k, v, causal=False)
        assert torch.equal(alone[:, 0], batched[:, i]), i
