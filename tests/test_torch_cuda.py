"""Each hand-written CUDA kernel against its plain PyTorch version, on a card.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""
import pytest
import torch

from repro_torch.core.packing import pack_weight
from repro_torch.kernels import ops, ref
from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda
from repro_torch.serving.kvcache import kv_quantize


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the CPU the plain versions are tested")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 40])
def test_cuda_matmul_matches_plain(cuda_device, m):
    """Within 1e-5 * (|x| @ |w|) + 1e-6: bf16 x, so only the f32 summation
    order differs."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    pw = pack_weight(torch.randn((512, 192), generator=g, device=cuda_device))
    x = torch.randn((m, 512), generator=g, device=cuda_device).to(torch.bfloat16)
    got = ops.razer_matmul(x.float(), pw)
    want = ref.razer_matmul_ref(x, pw)
    bound = 1e-5 * (x.float().abs() @ pw.dequantize().abs()) + 1e-6
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_act_qdq_bit_exact(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randn((64, 3072), generator=g, device=cuda_device) * 3).to(dtype)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(razer_act_qdq_cuda(x).view(view), ref.razer_act_qdq_ref(x).view(view))


@pytest.mark.cuda
def test_cuda_kv_attention_matches_plain(cuda_device):
    """G = 3, ragged cur_len; within rtol = atol = 1e-4 (f32, expf, other order)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    kc, km = kv_quantize(torch.randn((3, 96, 2, 64), generator=g, device=cuda_device))
    vc, vm = kv_quantize(torch.randn((3, 96, 2, 64), generator=g, device=cuda_device))
    q = torch.randn((3, 6, 64), generator=g, device=cuda_device)
    cur = torch.tensor([1, 50, 96], dtype=torch.int32, device=cuda_device)
    got = razer_kv_attention_cuda(q, kc, km, vc, vm, cur)
    torch.testing.assert_close(got, ref.razer_kv_attention_ref(q, kc, km, vc, vm, cur), rtol=1e-4, atol=1e-4)
