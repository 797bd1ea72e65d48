"""Sliding-window attention in the port against the JAX package, on the CPU:
K9's plain version (``ops.prefill_attention``, what ``chunked_attention``
runs off the card) with a window against the JAX ``chunked_attention(window=)``
at window 1, a window inside the sequence and one past it, at head widths
16 and 256, with and without a ``q_offset``; ``decode_attention(window=)``
at ragged lengths; ``quantized_kv_append`` and ``quantized_kv_prefill``
byte for byte; and the windowed ``gqa_decode`` over the packed cache (the
whole cache dequantized, then the plain decode attention, as in the
reference), with the paged path's refusal.  Float32 within 1e-5, bf16
within ``BF16_TOL`` (the plain version's rounding of P to bf16 can move
one output ulp against XLA's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_cases import configs
from repro.models import attention as jattn
from repro.serving import kvcache as jkv
from repro_torch.bridge import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.serving import kvcache as tkv

F32_TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-9)
KV_NAMES = ("k_codes", "k_meta", "v_codes", "v_meta")


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 5, 64], ids=["w1", "w_inside", "w_past_s"])
@pytest.mark.parametrize("hd,h,kvh,s", [(16, 4, 1, 24), (256, 10, 1, 20)], ids=["hd16", "hd256"])
def test_plain_prefill_attention_with_a_window(dtype, window, hd, h, kvh, s):
    q, k, v = _rand((2, s, h, hd), 1), _rand((2, s, kvh, hd), 2), _rand((2, s, kvh, hd), 3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.chunked_attention(*(jnp.asarray(t).astype(jd) for t in (q, k, v)), causal=True, window=window,
                                   kv_chunk=8)
    got = ops.prefill_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)), causal=True, window=window,
                                kv_chunk=8)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("hd", [16, 256])
def test_plain_prefill_attention_window_with_a_q_offset(hd):
    """A continuation: queries at positions 13 .. 28 against 29 keys, window
    6 (the first rows' windows reach before the offset), equal to the
    reference's and to the same rows of the whole prompt."""
    off, skv, h = 13, 29, 2
    q, k, v = _rand((1, skv, h, hd), 4), _rand((1, skv, 1, hd), 5), _rand((1, skv, 1, hd), 6)
    sfx = q[:, off:]
    want = jattn.chunked_attention(*(jnp.asarray(t) for t in (sfx, k, v)), causal=True, window=6, q_offset=off)
    got = tattn.chunked_attention(*(torch.from_numpy(t) for t in (sfx, k, v)), causal=True, window=6, q_offset=off)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    whole = tattn.chunked_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=True, window=6)
    np.testing.assert_allclose(_np(got), _np(whole[:, off:]), **F32_TOL)


@pytest.mark.parametrize("window", [0, 1, 4, 40])
def test_decode_attention_with_a_window(window):
    b, smax, h, kvh, hd = 3, 24, 4, 2, 16
    q, kc, vc = _rand((b, 1, h, hd), 8), _rand((b, smax, kvh, hd), 9), _rand((b, smax, kvh, hd), 10)
    cur = np.array([3, 11, 24], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur), window=window)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                 torch.from_numpy(cur), window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_quantized_kv_append_and_prefill_bytes():
    """The same wire bytes and the same dequantized caches as the reference,
    at positions off the 16-element blocks' grid."""
    jcfg, tcfg = configs("recurrentgemma_2b")
    b, max_len, kvh, hd = 2, 24, tcfg.num_kv_heads, tcfg.hd
    k, v = _rand((b, 11, kvh, hd), 11), _rand((b, 11, kvh, hd), 12)
    jc = jkv.quantized_kv_prefill(jkv.quantized_gqa_cache_init(jcfg, b, max_len), jnp.asarray(k), jnp.asarray(v))
    tc = tkv.quantized_kv_prefill(tkv.quantized_gqa_cache_init(tcfg, b, max_len, "cpu"), torch.from_numpy(k),
                                  torch.from_numpy(v))
    for name in KV_NAMES:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)
    kn, vn = _rand((b, 1, kvh, hd), 13), _rand((b, 1, kvh, hd), 14)
    cur = np.array([11, 7], np.int32)
    jk, jv, jc = jkv.quantized_kv_append(jc, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(cur))
    tk, tv, tc = tkv.quantized_kv_append(tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(cur))
    for name in KV_NAMES:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    assert tk.dtype == torch.float32


@pytest.fixture(scope="module")
def attention_layer():
    jcfg, tcfg = configs("recurrentgemma_2b")
    tree = jax.tree_util.tree_map(np.asarray, jattn.gqa_init(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("packed", [False, True], ids=["bf16_cache", "packed_cache"])
def test_windowed_gqa_decode(attention_layer, packed):
    """One decode step of the hybrid's attention layer with its window of 8
    at ragged positions 3 and 15 (the second past the window): the output
    within 1e-5 and the cache written alike (packed bytes equal)."""
    jcfg, tcfg, jp, tp = attention_layer
    b, max_len = 2, 24
    x = _rand((b, 1, tcfg.d_model), 15)
    cur = np.array([3, 15], np.int32)
    k0, v0 = _rand((b, max_len, tcfg.num_kv_heads, tcfg.hd), 16), _rand((b, max_len, tcfg.num_kv_heads, tcfg.hd), 17)
    if packed:
        jc = jkv.quantized_kv_prefill(jkv.quantized_gqa_cache_init(jcfg, b, max_len), jnp.asarray(k0), jnp.asarray(v0))
        tc = {n: torch.from_numpy(np.array(jc[n])) for n in KV_NAMES}
    else:
        jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
        tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    wy, wc = jattn.gqa_decode(jnp.asarray(x), jp, jcfg, jc, jnp.asarray(cur), quant=jattn.DEFAULT_QUANT,
                              window=jcfg.window)
    gy, gc = tattn.gqa_decode(torch.from_numpy(x), tp, tcfg, tc, torch.from_numpy(cur), quant=QuantPolicy.bf16(),
                              window=tcfg.window)
    np.testing.assert_allclose(_np(gy), _np(wy), **F32_TOL)
    for name in wc:
        if packed:
            np.testing.assert_array_equal(gc[name].numpy(), np.asarray(wc[name]), err_msg=name)
        else:
            np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), **F32_TOL)


def test_paged_decode_refuses_a_window(attention_layer):
    _, tcfg, _, tp = attention_layer
    with pytest.raises(ValueError, match="paged KV decode does not support sliding windows"):
        tattn.gqa_decode(torch.zeros(1, 1, tcfg.d_model), tp, tcfg, {}, torch.zeros(1, dtype=torch.int32),
                         window=8, pages=torch.zeros((1, 2), dtype=torch.int32))
