"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's kernel wrappers run their plain PyTorch versions; they
are held here against the JAX oracles (``repro.kernels.ref``) and the Pallas
kernels in interpret mode.  ``test_torch_cuda.py`` holds the CUDA kernels
against the same plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_weight as jax_pack_weight
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.razer_kv_attention import razer_kv_attention_pallas
from repro.kernels.razer_quantize import razer_act_qdq_pallas
from repro.serving.kvcache import kv_quantize as jax_kv_quantize
from repro_torch.bridge import packed_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
from repro_torch.kernels.razer_matmul import razer_matmul_cuda
from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

torch.set_num_threads(2)


def _int_view(a) -> np.ndarray:
    """The raw bits of a bf16 or f32 array (JAX or torch) as integers, so
    that equality is bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _torch_from_jax(a) -> torch.Tensor:
    """A JAX array -> torch tensor with the same bits."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _act_inputs(m, k, scale, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * scale).astype(np.float32)
    x[0, :16] = 0.0  # an all-zero block
    x[0, 16:32] = np.array([0.0, 1.0, -1.0, 5.0, -5.0, 4.5, -4.5, 5.5] * 2, np.float32)  # ties
    return x


# ---------------------------------------------------------------------------
# K2: activation fake-quant -- bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-4, 1.0, 100.0, 3000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_qdq_plain_bit_exact_vs_jax(scale, dtype):
    """The plain version equals ``ref.razer_act_qdq_ref`` bit for bit
    (tolerance 0), f32 and bf16, including the E4M3-saturating regime
    (absmax / 6 > 448), and the Pallas kernel in interpret mode wherever that
    kernel agrees with its own oracle.  In the saturating bf16 case the
    Pallas kernel departs from the oracle on 3 of 4096 elements; the port
    follows the oracle there, and the test pins that exact count."""
    x = _act_inputs(16, 256, scale, seed=int(scale * 7) % 101)
    jx = jnp.asarray(x).astype(dtype)
    want_ref = jax_ref.razer_act_qdq_ref(jx)
    want_pallas = razer_act_qdq_pallas(jx, block_m=16, block_k=256, interpret=True)
    got = ref.razer_act_qdq_ref(_torch_from_jax(jx))
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    np.testing.assert_array_equal(_int_view(got), _int_view(want_ref))
    pallas_off_oracle = _int_view(want_pallas) != _int_view(want_ref)
    assert int(pallas_off_oracle.sum()) == (3 if (dtype, scale) == ("bfloat16", 3000.0) else 0)
    np.testing.assert_array_equal(_int_view(got)[~pallas_off_oracle], _int_view(want_pallas)[~pallas_off_oracle])


def test_act_qdq_ops_routes_cpu_to_plain_with_batch_dims():
    x = torch.from_numpy(_act_inputs(6, 64, 2.0, seed=3)).reshape(2, 3, 64)
    before = razer_act_qdq_cuda.launches
    y = ops.razer_act_qdq(x)
    assert razer_act_qdq_cuda.launches == before
    assert torch.equal(y, ref.razer_act_qdq_ref(x.reshape(6, 64)).reshape(2, 3, 64))


# ---------------------------------------------------------------------------
# K1: packed GEMM -- within f32 reduction order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,svs", [(4, 64, 32, (5.0, 8.0)), (32, 256, 64, (5.0, 7.0)),
                                       (3, 512, 16, (5.0, 9.0))])
def test_matmul_plain_matches_jax(m, k, n, svs):
    """Same wire bytes in both packages: the dequantized weights are equal
    (tolerance 0) and y agrees with ``ops.razer_matmul`` (JAX, CPU)
    elementwise within 1e-5 * (|x| @ |w|) + 1e-6, a bound on f32 sums taken
    in another order."""
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jpw = jax_pack_weight(jnp.asarray(w), sv_magnitudes=svs)
    pw = packed_from_numpy(np.asarray(jpw.codes), np.asarray(jpw.scale_meta),
                           np.asarray(jpw.tensor_scale), jpw.sv_magnitudes, jpw.shape, device="cpu")
    w_deq = pw.dequantize()
    np.testing.assert_array_equal(w_deq.numpy(), np.asarray(jpw.dequantize()))
    want = np.asarray(jax_ops.razer_matmul(jnp.asarray(x), jpw))
    got = ops.razer_matmul(torch.from_numpy(x), pw).numpy()
    bound = 1e-5 * (np.abs(x) @ np.abs(w_deq.numpy())) + 1e-6
    assert (np.abs(got - want) <= bound).all()


def test_matmul_ops_flattens_batch_dims_and_casts():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    jpw = jax_pack_weight(jnp.asarray(w))
    pw = packed_from_numpy(np.asarray(jpw.codes), np.asarray(jpw.scale_meta),
                           np.asarray(jpw.tensor_scale), jpw.sv_magnitudes, jpw.shape, device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32)).to(torch.bfloat16)
    before = razer_matmul_cuda.launches
    y = ops.razer_matmul(x, pw)
    assert razer_matmul_cuda.launches == before
    assert y.shape == (2, 3, 32) and y.dtype == torch.bfloat16
    assert torch.equal(y, ref.razer_matmul_ref(x.reshape(6, 64), pw).reshape(2, 3, 32).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# K3: packed-KV decode attention -- within f32 tolerance
# ---------------------------------------------------------------------------
def _packed_cache(b, s, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("k", "v"):
        codes, meta = jax_kv_quantize(jnp.asarray(rng.standard_normal((b, s, kvh, hd)).astype(np.float32)))
        out[f"{name}_codes"], out[f"{name}_meta"] = np.array(codes), np.array(meta)
    return out


@pytest.mark.parametrize("b,s,h,kvh,hd,cur", [
    (2, 64, 4, 2, 32, 50),            # G = 2, scalar cur_len
    (2, 64, 4, 2, 32, [20, 47]),      # G = 2, per-sequence cur_len
    (1, 64, 8, 8, 16, 64),            # MHA, full cache
    (3, 32, 6, 2, 32, [1, 17, 32]),   # G = 3, ragged
])
def test_kv_attention_plain_matches_pallas(b, s, h, kvh, hd, cur):
    """Plain version vs ``razer_kv_attention_pallas`` (interpret mode) and
    ``ref.razer_kv_attention_ref``: within rtol = atol = 2e-5 (f32 softmax
    and sums in another order)."""
    rng = np.random.default_rng(b * s + h)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    cache = _packed_cache(b, s, kvh, hd, seed=s + kvh)
    args = [cache[n] for n in ("k_codes", "k_meta", "v_codes", "v_meta")]
    cur_np = np.asarray(cur, np.int32)
    want = np.asarray(razer_kv_attention_pallas(jnp.asarray(q), *map(jnp.asarray, args),
                                                jnp.asarray(cur_np), seq_chunk=32, interpret=True))
    want_ref = np.asarray(jax_ref.razer_kv_attention_ref(jnp.asarray(q), *map(jnp.asarray, args), cur_np))
    got = ref.razer_kv_attention_ref(torch.from_numpy(q), *map(torch.from_numpy, args),
                                     torch.from_numpy(cur_np)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)


def test_kv_attention_ops_routes_cpu_to_plain():
    from repro_torch.serving.kvcache import kv_quantize

    rng = np.random.default_rng(4)
    cache = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal((2, 32, 2, 32)).astype(np.float32))
        cache[f"{name}_codes"], cache[f"{name}_meta"] = kv_quantize(x)
    q = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 1, 4, 32)).astype(np.float32))
    before = razer_kv_attention_cuda.launches
    y = ops.razer_kv_attention(q, cache, torch.tensor([5, 30]))
    assert razer_kv_attention_cuda.launches == before and y.shape == (2, 1, 4, 32)
    want = ref.razer_kv_attention_ref(q[:, 0], cache["k_codes"], cache["k_meta"], cache["v_codes"],
                                      cache["v_meta"], torch.tensor([5, 30]))
    assert torch.equal(y[:, 0], want)
