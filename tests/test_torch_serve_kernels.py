"""The port's paged-attention kernel modules (K4 ``paged_kv_attention`` and
K5 ``paged_kv_attention_verify``) against the JAX package's Pallas kernels
in interpret mode, on the CPU where the port runs their plain versions.
Mirrors ``tests/test_paged_serving.py`` (kernel cases at :110, :166, :182
and :198); ``test_torch_cuda.py`` holds the CUDA kernels against the same
plain versions on a card.  Also the nvfp4 quantizer the default draft uses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nvfp4 import nvfp4_qdq as jax_nvfp4_qdq
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.kernels import ops as jax_ops
from repro.serving.kvcache import kv_quantize as jax_kv_quantize
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_kv_attention import paged_kv_attention_cuda, paged_kv_attention_verify_cuda

torch.set_num_threads(2)
TOL = 1e-5  # f32: the plain versions and the Pallas kernels sum in other orders


def _pool(rng, p, ps, kvh, hd):
    """Random wire-format pool arrays, as (jax dict, torch dict)."""
    kc, km = jax_kv_quantize(jnp.asarray(rng.standard_normal((p, ps, kvh, hd)), jnp.float32))
    vc, vm = jax_kv_quantize(jnp.asarray(rng.standard_normal((p, ps, kvh, hd)), jnp.float32))
    jcache = {"k_codes": kc, "k_meta": km, "v_codes": vc, "v_meta": vm}
    return jcache, {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}


def _fixture(rng, b, kvh, hd, ps, npg):
    """A pool and DISJOINT page tables in scrambled physical order."""
    p = b * npg + 1
    jcache, tcache = _pool(rng, p, ps, kvh, hd)
    pt = rng.permutation(np.arange(1, p)).reshape(b, npg).astype(np.int32)
    return jcache, tcache, pt


def test_paged_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    b, h, kvh, hd, ps, p = 3, 4, 2, 32, 8, 9
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    jcache, tcache = _pool(rng, p, ps, kvh, hd)
    pt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 2]], np.int32)
    cl = np.asarray([25, 9, 30], np.int32)
    want = jax_ops.razer_paged_kv_attention(jnp.asarray(q), jcache, jnp.asarray(pt), jnp.asarray(cl),
                                            force_pallas=True, interpret=True)
    got = ops.razer_paged_kv_attention(torch.from_numpy(q), tcache, torch.from_numpy(pt), torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("t", [1, 3])
def test_verify_plain_matches_pallas_interpret(ps, t):
    """cur_len at a page boundary, mid-page and near the table's end."""
    rng = np.random.default_rng(ps * 10 + t)
    b, h, kvh, hd, npg = 3, 4, 2, 32, 4
    jcache, tcache, pt = _fixture(rng, b, kvh, hd, ps, npg)
    cl = np.asarray([ps - 1, ps + ps // 2, npg * ps - t - 1], np.int32)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    want = jax_ops.razer_paged_kv_attention_verify(jnp.asarray(q), jcache, jnp.asarray(pt), jnp.asarray(cl),
                                                   force_pallas=True, interpret=True)
    got = ops.razer_paged_kv_attention_verify(torch.from_numpy(q), tcache, torch.from_numpy(pt),
                                              torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("ps", [4, 16])
def test_paged_plain_matches_pallas_at_decode_shapes(ps):
    """Single-query kernel on a scattered table with an idle slot (cur_len
    1 over an all-null row, what an idle decode slot attends)."""
    rng = np.random.default_rng(ps)
    b, h, kvh, hd, npg = 4, 4, 2, 16, 4
    jcache, tcache, pt = _fixture(rng, b, kvh, hd, ps, npg)
    pt[3] = 0
    cl = np.asarray([1, ps, 2 * ps + 3, 1], np.int32)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    want = jax_ops.razer_paged_kv_attention(jnp.asarray(q), jcache, jnp.asarray(pt), jnp.asarray(cl),
                                            force_pallas=True, interpret=True)
    got = ops.razer_paged_kv_attention(torch.from_numpy(q), tcache, torch.from_numpy(pt), torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_verify_t1_equals_single_query_plain():
    """T = 1 verify at committed length c is the decode step at c + 1."""
    rng = np.random.default_rng(7)
    b, h, kvh, hd, ps, npg = 2, 4, 2, 32, 8, 3
    _, tcache, pt = _fixture(rng, b, kvh, hd, ps, npg)
    cl = torch.tensor([13, 20], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(np.float32))
    verify = ops.razer_paged_kv_attention_verify(q, tcache, torch.from_numpy(pt), cl)
    single = ops.razer_paged_kv_attention(q[:, 0], tcache, torch.from_numpy(pt), cl + 1)
    assert torch.equal(verify[:, 0], single)


@pytest.mark.parametrize("ps", [4, 8])
def test_verify_masks_rollback_shaped_tails(ps):
    """Stale bytes past cur_len + t (a rolled-back speculative tail) never
    reach any query, in the plain version or the Pallas kernel."""
    rng = np.random.default_rng(11)
    b, h, kvh, hd, npg, t = 2, 4, 2, 32, 4, 3
    jcache, tcache, pt = _fixture(rng, b, kvh, hd, ps, npg)
    cl = np.asarray([ps + 1, 2 * ps - 1], np.int32)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    clean = ops.razer_paged_kv_attention_verify(torch.from_numpy(q), tcache, torch.from_numpy(pt),
                                                torch.from_numpy(cl))
    dirty = {k: v.clone() for k, v in tcache.items()}
    for i in range(b):
        for pos in range(int(cl[i]) + t, npg * ps):
            pg, slot = int(pt[i, pos // ps]), pos % ps
            for key in dirty:
                dirty[key][pg, slot] = torch.from_numpy(rng.integers(0, 256, dirty[key].shape[2:]).astype(np.uint8))
    got = ops.razer_paged_kv_attention_verify(torch.from_numpy(q), dirty, torch.from_numpy(pt), torch.from_numpy(cl))
    assert torch.equal(got, clean)
    pallas = jax_ops.razer_paged_kv_attention_verify(
        jnp.asarray(q), {k: jnp.asarray(v.numpy()) for k, v in dirty.items()}, jnp.asarray(pt), jnp.asarray(cl),
        force_pallas=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=TOL)


def test_paged_plain_equals_contiguous_plain():
    """Pages holding each sequence contiguously score exactly like the
    contiguous cache (the same wire bytes)."""
    rng = np.random.default_rng(2)
    b, h, kvh, hd, ps = 2, 4, 2, 32, 8
    k = torch.from_numpy(rng.standard_normal((b, 3 * ps, kvh, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, 3 * ps, kvh, hd)).astype(np.float32))
    from repro_torch.serving.kvcache import kv_quantize

    (kc, km), (vc, vm) = kv_quantize(k), kv_quantize(v)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    cl = torch.tensor([19, 11], dtype=torch.int32)
    contiguous = ref.razer_kv_attention_ref(q, kc, km, vc, vm, cl)

    def pooled(x):
        pages = x.reshape(b * 3, ps, kvh, x.shape[-1])
        return torch.cat([torch.zeros_like(pages[:1]), pages])

    pt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    paged = ref.paged_kv_attention_ref(q, pooled(kc), pooled(km), pooled(vc), pooled(vm), pt, cl)
    assert torch.equal(contiguous, paged)


def test_paged_wrappers_reject_cpu_tensors():
    """The CUDA wrappers raise on CPU tensors; only ``ops`` routes them to
    the plain versions."""
    u8 = lambda *s: torch.zeros(s, dtype=torch.uint8)  # noqa: E731
    pool = (u8(3, 4, 1, 16), u8(3, 4, 1, 2), u8(3, 4, 1, 16), u8(3, 4, 1, 2))
    pt, cl = torch.zeros((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_kv_attention_cuda(torch.zeros(1, 2, 32), *pool, pt, cl)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_kv_attention_verify_cuda(torch.zeros(1, 2, 2, 32), *pool, pt, cl)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_nvfp4_fakequant_bit_exact_vs_jax(scale):
    """The default draft's weight fake-quant (nvfp4 under a weight spec:
    E3M3 block scales, no special values) equals the JAX package's."""
    rng = np.random.default_rng(int(scale * 1000))
    w = (rng.standard_normal((64, 48)) * scale).astype(np.float32)
    w[:16, 0] = 0.0  # an all-zero block
    want = JaxPolicy.fakequant("nvfp4").weight.qdq(jnp.asarray(w), axis=0)
    got = QuantPolicy.fakequant("nvfp4").weight.qdq(torch.from_numpy(w), axis=0)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(np.asarray(jax_nvfp4_qdq(jnp.asarray(w))),
                                  QuantPolicy.fakequant("nvfp4", weight_scale_fmt="e4m3").weight.qdq(
                                      torch.from_numpy(w)).numpy())
