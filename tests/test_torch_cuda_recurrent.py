"""The prefill kernel K9 with a sliding window, at RecurrentGemma's head width
256 (10 query heads on 1 KV head) and at narrower widths, on a card,
against its plain version, and the row invariance the serving invariants
rest on: a row's bits do not move with the batch, the padding or a
``q_offset`` that is not a multiple of the kernel's 64-key chunk.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_recurrent.py
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.prefill_attention import kernel_body, prefill_attention_cuda

# as tests/test_torch_cuda_zoo.py: f32 V with a bf16 q within one bf16 ulp
# and 1e-6, an f32 q within 1e-5; bf16 V within 2^-7 |want| + 2^-9, except,
# as chip_smoke.py's ``_assert_prefill_close``, the outputs of at most FLIPS_MAX
# (query, head) rows, each within what one flip of P's bf16 rounding can move: 2^-9 + 2^-7
# |want| + 2 * 2^-7 max_j p_j |v_j| / l
F32_V_TOL = dict(rtol=2**-7, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_V_TOL = dict(rtol=2**-7, atol=2**-9)
FLIPS_MAX = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the CPU the plain versions are tested")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, b, s, h, kvh, hd, q_dtype, kv_dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=device).to(q_dtype)
    k, v = (torch.randn((b, s, kvh, hd), generator=g, device=device).to(kv_dtype) for _ in range(2))
    return q, k, v


def _assert_close(got, q, k, v, **mask):
    want = ref.chunked_attention_ref(q, k, v, **mask)
    if v.dtype != torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), **(F32_TOL if q.dtype == torch.float32 else F32_V_TOL))
        return
    err = (got.float() - want.float()).abs()
    outside = (err > BF16_V_TOL["atol"] + BF16_V_TOL["rtol"] * want.float().abs()).nonzero().tolist()
    rows = sorted({(b, i, h) for b, i, h, _ in outside})
    if len(rows) > FLIPS_MAX:
        torch.testing.assert_close(got.float(), want.float(), **BF16_V_TOL)
    skv, kvh = k.shape[1], k.shape[2]
    onehot = torch.eye(skv, device=q.device).reshape(1, skv, 1, skv).expand(1, skv, kvh, skv)
    for b, i, h, d in outside:
        row_mask = dict(mask, q_offset=mask.get("q_offset", 0) + i)
        w = ref.chunked_attention_ref(q[b:b + 1, i:i + 1].float(), k[b:b + 1], onehot, **row_mask)[0, 0, h]
        term = float((w * v[b, :, h // (q.shape[2] // kvh), d].float().abs()).max())
        assert float(err[b, i, h, d]) <= 2**-9 + 2**-7 * abs(float(want[b, i, h, d])) + 2 * 2**-7 * term, (b, i, h, d)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                                              (torch.bfloat16, torch.float32)], ids=["bf16", "f32", "bf16q_f32kv"])
@pytest.mark.parametrize("window", [1, 100, 2048])
def test_cuda_hd256_window_matches_plain(cuda_device, q_dtype, kv_dtype, window):
    """hd 256, G 10, causal with the window, 400 positions (window 2048 is
    wider than the prompt); a bf16 q with f32 K/V runs the f32 body."""
    q, k, v = _inputs(cuda_device, 2, 400, 10, 1, 256, q_dtype, kv_dtype, seed=window)
    got = prefill_attention_cuda(q, k, v, window=window)
    assert got.shape == q.shape and got.dtype == q_dtype
    _assert_close(got, q, k, v, window=window)
    assert kernel_body(q_dtype, 256, kv_dtype == torch.bfloat16) == (
        "tensor_core" if q_dtype == kv_dtype == torch.bfloat16 else "f32")


@pytest.mark.cuda
@pytest.mark.parametrize("hd,h,kvh", [(256, 10, 1), (128, 8, 2), (16, 4, 1)])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_cuda_window_rows_do_not_move(cuda_device, hd, h, kvh, q_dtype):
    """Window 150 over 300 positions: each prompt alone at its own length ==
    its rows inside the batch, and a continuation at q_offset 131 (not a
    multiple of 64, its first rows' windows reaching before it) == the same
    rows of the whole prompt, bit for bit."""
    kv_dtype = torch.bfloat16 if hd == 256 else torch.float32
    q, k, v = _inputs(cuda_device, 2, 300, h, kvh, hd, q_dtype, kv_dtype, seed=hd)
    got = prefill_attention_cuda(q, k, v, window=150)
    _assert_close(got, q, k, v, window=150)
    for r, n in ((0, 211), (1, 300)):
        alone = prefill_attention_cuda(*(t[r:r + 1, :n].contiguous() for t in (q, k, v)), window=150)
        assert torch.equal(alone[0], got[r, :n]), (r, n)
    sfx = prefill_attention_cuda(q[1:, 131:].contiguous(), k[1:].contiguous(), v[1:].contiguous(), window=150,
                                 q_offset=131)
    assert torch.equal(sfx[0], got[1, 131:])


@pytest.mark.cuda
def test_cuda_window_refuses_a_row_without_keys(cuda_device):
    q, k, v = _inputs(cuda_device, 1, 8, 2, 1, 16, torch.bfloat16, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="has no key"):
        prefill_attention_cuda(q, k, v, window=2, q_offset=20)
