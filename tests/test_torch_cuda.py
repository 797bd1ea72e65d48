"""Each hand-written CUDA kernel against its plain PyTorch version, on a card,
and the bit-identities the serving invariants rest on.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""
import pytest
import torch

from repro_torch.core.packing import pack_stacked_weights, pack_weight
from repro_torch.kernels import attention_plan, ops, ref
from repro_torch.kernels.paged_kv_attention import paged_kv_attention_cuda, paged_kv_attention_verify_cuda
from repro_torch.kernels.prefill_attention import prefill_attention_cuda
from repro_torch.kernels.razer_grouped_matmul import razer_grouped_matmul_cuda, razer_grouped_matmul_kshard_cuda
from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
from repro_torch.kernels.razer_matmul import razer_matmul_cuda, razer_matmul_kshard_cuda
from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda
from repro_torch.serving.kvcache import kv_dequantize, kv_quantize


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


_ACT_SVS = [(5.0, -5.0), (5.0, -5.0, 8.0, -8.0)]


def _act_x(device, m, k, dtype, seed):
    """Activations x 3 with an all-zero block and ties on the FP4 midpoints."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device) * 3
    x[0, :16] = 0.0
    x[0, 16:32] = torch.tensor([0.0, 1.0, -1.0, 5.0, -5.0, 4.5, -4.5, 5.5] * 2, device=device)
    return x.to(dtype)


def _view(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_act_qdq_bit_exact(cuda_device, dtype):
    """K2 equals its plain version bit for bit, for the activation set (5,
    -5) and a set of four special values."""
    x = _act_x(cuda_device, 64, 3072, dtype, seed=1)
    for svs in _ACT_SVS:
        assert torch.equal(_view(razer_act_qdq_cuda(x, svs)), _view(ref.razer_act_qdq_ref(x, svs=svs))), svs


@pytest.mark.cuda
def test_cuda_act_qdq_rows_bit_identical_across_m(cuda_device):
    """K2 quantizes each 16-value block on its own: a row's bits do not move
    with M, up to prefill's 8 x 128 rows."""
    x = _act_x(cuda_device, 1024, 3072, torch.bfloat16, seed=2)
    whole = razer_act_qdq_cuda(x)
    for m in (1, 4, 12, 128):
        assert torch.equal(_view(razer_act_qdq_cuda(x[:m].contiguous())), _view(whole[:m])), m


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


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(512, 192), (3072, 1024), (3072, 3072)])
def test_cuda_matmul_row_bit_identical_across_m(cuda_device, k, n):
    """K1's split-K boundaries depend on (N, K) only: the first rows' output
    is bit for bit the same at every batch size up to prefill's 8 x 128
    rows, plain and with the activation fake-quant (fused into the load and
    as K2 then K1, at every M)."""
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    pw = pack_weight(torch.randn((k, n), generator=g, device=cuda_device) / k**0.5)
    x = (torch.randn((1024, k), generator=g, device=cuda_device) * 3).to(torch.bfloat16)
    m0, m1 = pw.sv_magnitudes
    for act in ({}, {"act_svs": (5.0, -5.0), "fused": True}, {"act_svs": (5.0, -5.0), "fused": False}):
        outs = [razer_matmul_cuda(x[:m].contiguous(), pw.codes, pw.scale_meta, m0=m0, m1=m1, **act)
                for m in (1, 4, 8, 24, 128, 1024)]
        for out in outs[1:]:
            assert torch.equal(out[:1], outs[0]), act


def _paged_fixture(device, b=4, h=24, kvh=8, hd=128, ps=16, npg=8, seed=3):
    """A pool of b * npg random pages (+ the null page) and scattered,
    disjoint page tables, at the llama3_2_3b head widths."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_pages = b * npg + 1
    pool = kv_quantize(torch.randn((n_pages, ps, kvh, hd), generator=g, device=device))
    pool += kv_quantize(torch.randn((n_pages, ps, kvh, hd), generator=g, device=device))
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.reshape(b, npg).to(torch.int32).to(device)
    q = torch.randn((b, h, hd), generator=g, device=device)
    return q, pool, table


@pytest.mark.cuda
def test_cuda_paged_matches_plain(cuda_device):
    """K4 within rtol = atol = 1e-4 of its plain version on a scattered table
    (f32, expf, another summation order), cur_len 9/40/97/128."""
    q, pool, table = _paged_fixture(cuda_device)
    cur = torch.tensor([9, 40, 97, 128], dtype=torch.int32, device=cuda_device)
    got = paged_kv_attention_cuda(q, *pool, table, cur, check_pages=True)
    torch.testing.assert_close(got, ref.paged_kv_attention_ref(q, *pool, table, cur), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3])
def test_cuda_verify_matches_plain(cuda_device, t):
    q, pool, table = _paged_fixture(cuda_device)
    qt = torch.randn((4, t, 24, 128), generator=torch.Generator(device=cuda_device).manual_seed(t),
                     device=cuda_device)
    cur = torch.tensor([0, 15, 60, 124], dtype=torch.int32, device=cuda_device)
    got = paged_kv_attention_verify_cuda(qt, *pool, table, cur, check_pages=True)
    want = ref.paged_kv_attention_verify_ref(qt, *pool, table, cur)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_paged_equals_contiguous_bitwise(cuda_device):
    """K4 over pages that hold each sequence contiguously returns K3's bits
    on the same bytes: the two kernels share one attention body."""
    q, pool, _ = _paged_fixture(cuda_device)
    b, npg, ps = 4, 8, 16
    table = (1 + torch.arange(b * npg, dtype=torch.int32, device=cuda_device)).reshape(b, npg)
    contiguous = [x[1:].reshape(b, npg * ps, *x.shape[2:]).contiguous() for x in pool]
    cur = torch.tensor([9, 40, 97, 128], dtype=torch.int32, device=cuda_device)
    assert torch.equal(paged_kv_attention_cuda(q, *pool, table, cur),
                       razer_kv_attention_cuda(q, *contiguous, cur))


@pytest.mark.cuda
def test_cuda_verify_queries_equal_decode_bitwise(cuda_device):
    """K5's query t at committed length c returns K4's bits at length
    c + t + 1 (T = 1 included): the reduction of a vanilla decode step."""
    _, pool, table = _paged_fixture(cuda_device)
    qt = torch.randn((4, 3, 24, 128), generator=torch.Generator(device=cuda_device).manual_seed(5),
                     device=cuda_device)
    cur = torch.tensor([0, 15, 60, 124], dtype=torch.int32, device=cuda_device)
    got = paged_kv_attention_verify_cuda(qt, *pool, table, cur)
    for t in range(3):
        want = paged_kv_attention_cuda(qt[:, t].contiguous(), *pool, table, cur + t + 1)
        assert torch.equal(got[:, t], want)
    one = paged_kv_attention_verify_cuda(qt[:, :1].contiguous(), *pool, table, cur)
    assert torch.equal(one[:, 0], paged_kv_attention_cuda(qt[:, 0].contiguous(), *pool, table, cur + 1))


def _bank(device, e, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return pack_stacked_weights(torch.randn((e, k, n), generator=g, device=device) / k**0.5), g


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 13, 48])
def test_cuda_grouped_matmul_matches_plain(cuda_device, m):
    """K6 within 1e-5 * (|x| @ |w|) + 1e-6 of its plain version, per expert
    (bf16 x: only the f32 summation order differs), ragged M included."""
    pst, g = _bank(cuda_device, 4, 512, 192, seed=m)
    x = torch.randn((4, m, 512), generator=g, device=cuda_device).to(torch.bfloat16)
    got = ops.razer_grouped_matmul(x.float(), pst)
    want = ref.razer_grouped_matmul_ref(x, pst)
    bound = 1e-5 * torch.einsum("emk,ekn->emn", x.float().abs(), pst.dequantize().abs()) + 1e-6
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(512, 192), (3072, 1024), (1024, 3072)])
def test_cuda_grouped_expert_equals_dense_kernel_bitwise(cuda_device, k, n):
    """(a) expert e of K6 returns K1's bits on bank entry e: one tile body,
    the same (N, K) split count, the same ordered split sum."""
    pst, g = _bank(cuda_device, 3, k, n, seed=k + n)
    x = torch.randn((3, 8, k), generator=g, device=cuda_device).to(torch.bfloat16)
    m0, m1 = pst.sv_magnitudes
    got = razer_grouped_matmul_cuda(x, pst.codes, pst.scale_meta, m0=m0, m1=m1)
    for e in range(3):
        pw = pst[e]
        assert torch.equal(got[e], razer_matmul_cuda(x[e], pw.codes, pw.scale_meta, m0=m0, m1=m1))


@pytest.mark.cuda
def test_cuda_grouped_row_bit_identical_across_m(cuda_device):
    """(b) each expert's first row is bit for bit the same at every M."""
    pst, g = _bank(cuda_device, 4, 1024, 3072, seed=9)
    x = torch.randn((4, 48, 1024), generator=g, device=cuda_device).to(torch.bfloat16)
    m0, m1 = pst.sv_magnitudes
    outs = [razer_grouped_matmul_cuda(x[:, :m].contiguous(), pst.codes, pst.scale_meta, m0=m0, m1=m1)[:, :1]
            for m in (1, 4, 8, 24, 48)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def _unchunk(y):
    """(c, ..., N/c) chunk-major -> (..., N)."""
    return y.movedim(0, -2).reshape(*y.shape[1:-1], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m", [(1536, 8192, 4), (4096, 3072, 128), (768, 512, 13)])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_cuda_kshard_matmul_is_k1_permuted_bitwise(cuda_device, k, n, m, chunks):
    """K7 on a local shard: chunk r holds K1's columns [r N/c, (r+1) N/c)
    bit for bit (at c = 1, K1 itself), and within K1's tolerance of the
    plain version."""
    from repro_torch.core.packing import take_shard

    g = torch.Generator(device=cuda_device).manual_seed(k + n + m)
    whole = pack_weight(torch.randn((2 * k, n), generator=g, device=cuda_device) / (2 * k) ** 0.5)
    pw = take_shard(whole, tp=2, tp_index=1)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(torch.bfloat16)
    m0, m1 = pw.sv_magnitudes
    got = razer_matmul_kshard_cuda(x, pw.codes, pw.scale_meta, m0=m0, m1=m1, out_chunks=chunks)
    one = razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=m0, m1=m1)
    assert got.shape == (chunks, m, n // chunks) and torch.equal(_unchunk(got), one)
    want = ref.razer_matmul_ref(x, pw)
    bound = 1e-5 * (x.float().abs() @ pw.dequantize().abs()) + 1e-6
    assert bool(((_unchunk(got) * pw.tensor_scale - want).abs() <= bound).all())


@pytest.mark.cuda
def test_cuda_kshard_matmul_refuses_local_k_off_the_k_step(cuda_device):
    """K = 96 over tp 2 is eligible by the reference's rule (whole 16-blocks)
    but leaves a local K of 48, off the kernel's 64-deep K step: a clear
    error, never the plain version."""
    from repro_torch.core.packing import take_shard

    g = torch.Generator(device=cuda_device).manual_seed(0)
    local = take_shard(pack_weight(torch.randn((96, 64), generator=g, device=cuda_device)), tp=2, tp_index=0)
    x = torch.zeros((2, 48), device=cuda_device)
    with pytest.raises(ValueError, match="local K of this rank's shard is 48"):
        razer_matmul_kshard_cuda(x, local.codes, local.scale_meta, m0=5.0, m1=8.0, out_chunks=2)


@pytest.mark.cuda
@pytest.mark.parametrize("e,k,n,m", [(8, 1536, 2688, 4), (16, 1024, 768, 48)])
@pytest.mark.parametrize("chunks", [1, 2])
def test_cuda_kshard_grouped_matmul_is_k6_permuted_bitwise(cuda_device, e, k, n, m, chunks):
    pst, g = _bank(cuda_device, e, k, n, seed=e + k)
    x = torch.randn((e, m, k), generator=g, device=cuda_device).to(torch.bfloat16)
    m0, m1 = pst.sv_magnitudes
    got = razer_grouped_matmul_kshard_cuda(x, pst.codes, pst.scale_meta, m0=m0, m1=m1, out_chunks=chunks)
    six = razer_grouped_matmul_cuda(x, pst.codes, pst.scale_meta, m0=m0, m1=m1)
    assert got.shape == (chunks, e, m, n // chunks) and torch.equal(_unchunk(got), six)
    want = ref.razer_grouped_matmul_ref(x, pst)
    bound = 1e-5 * torch.einsum("emk,ekn->emn", x.float().abs(), pst.dequantize().abs()) + 1e-6
    assert bool(((_unchunk(got) * pst.tensor_scale[:, None, None] - want).abs() <= bound).all())


# The tile's edges: token tiles of 8 ... 128 and several of them (M 129,
# 257), column tiles cut by N (208: the 16-byte copies; 200: byte loads), one
# K split and several (a cluster summing in order), f32 x, an all-zero
# expert, out_chunks 2 and 4.
_EDGE_M = [1, 7, 8, 9, 64, 65, 129, 257]
_EDGE_KN = [(512, 192), (64, 200), (1024, 208), (640, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", _EDGE_KN)
def test_cuda_matmul_tile_edges_match_plain(cuda_device, k, n):
    """K1 within 1e-5 * (|x| @ |w|) + 1e-6 of its plain version at every
    edge M, and each row bit for bit the same at every M."""
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    pw = pack_weight(torch.randn((k, n), generator=g, device=cuda_device) / k**0.5)
    x = torch.randn((max(_EDGE_M), k), generator=g, device=cuda_device).to(torch.bfloat16)
    dense_abs = pw.dequantize().abs()
    m0, m1 = pw.sv_magnitudes
    first = None
    for m in _EDGE_M:
        xm = x[:m].contiguous()
        raw = razer_matmul_cuda(xm, pw.codes, pw.scale_meta, m0=m0, m1=m1)
        bound = 1e-5 * (xm.float().abs() @ dense_abs) + 1e-6
        assert bool(((raw * pw.tensor_scale - ref.razer_matmul_ref(xm, pw)).abs() <= bound).all()), f"M={m}"
        first = raw[:1] if first is None else first
        assert torch.equal(raw[:1], first), f"row 0 moves at M={m}"


@pytest.mark.cuda
def test_cuda_matmul_splits_one_and_many(cuda_device):
    """The edge shapes cover a single K split and cluster sums of 5 and 8."""
    from repro_torch.kernels.razer_matmul import launch_plan

    assert sorted({launch_plan(1, 4, n, k).splits for k, n in _EDGE_KN}) == [1, 5, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 9, 129])
def test_cuda_matmul_f32_x_equals_bf16_x_bitwise(cuda_device, m):
    """f32 x is rounded to bf16 (RN) as it is loaded: the same bits as the
    bf16 input."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    pw = pack_weight(torch.randn((1024, 208), generator=g, device=cuda_device))
    x = torch.randn((m, 1024), generator=g, device=cuda_device)
    m0, m1 = pw.sv_magnitudes
    want = razer_matmul_cuda(x.to(torch.bfloat16), pw.codes, pw.scale_meta, m0=m0, m1=m1)
    assert torch.equal(razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=m0, m1=m1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 65])
def test_cuda_grouped_edges_and_zero_expert(cuda_device, m):
    """K6 at edge M within the plain version's tolerance; expert e == K1 on
    entry e bit for bit; an expert whose x rows are all zero returns +0.0."""
    pst, g = _bank(cuda_device, 3, 640, 200, seed=m)
    x = torch.randn((3, m, 640), generator=g, device=cuda_device).to(torch.bfloat16)
    x[1] = 0
    m0, m1 = pst.sv_magnitudes
    raw = razer_grouped_matmul_cuda(x, pst.codes, pst.scale_meta, m0=m0, m1=m1)
    assert torch.equal(raw[1].view(torch.int32), torch.zeros_like(raw[1]).view(torch.int32))
    want = ref.razer_grouped_matmul_ref(x, pst)
    bound = 1e-5 * torch.einsum("emk,ekn->emn", x.float().abs(), pst.dequantize().abs()) + 1e-6
    assert bool(((raw * pst.tensor_scale[:, None, None] - want).abs() <= bound).all())
    for e in range(3):
        pw = pst[e]
        assert torch.equal(raw[e], razer_matmul_cuda(x[e], pw.codes, pw.scale_meta, m0=m0, m1=m1))


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [2, 4])
def test_cuda_kshard_grouped_chunks_at_edge_m(cuda_device, chunks):
    """K8 with out_chunks 2 and 4 at M 9 and 129: K6 permuted, bit for bit."""
    pst, g = _bank(cuda_device, 2, 512, 208, seed=chunks)
    m0, m1 = pst.sv_magnitudes
    for m in (9, 129):
        x = torch.randn((2, m, 512), generator=g, device=cuda_device).to(torch.bfloat16)
        got = razer_grouped_matmul_kshard_cuda(x, pst.codes, pst.scale_meta, m0=m0, m1=m1, out_chunks=chunks)
        assert torch.equal(_unchunk(got), razer_grouped_matmul_cuda(x, pst.codes, pst.scale_meta, m0=m0, m1=m1))


# --- the split decode-attention body (K3, K4, K5) -----------------------------------------------
# Lengths around a page (16), a split and several splits.
_SPLIT = attention_plan.SPLIT
_LENGTHS = [1, 15, 16, 17, _SPLIT - 1, _SPLIT, _SPLIT + 1, 3 * _SPLIT + 40]
_HEADS = [(3, 128), (4, 64), (6, 128), (8, 64), (2, 16), (1, 128)]  # (G, hd)


def _long_fixture(device, g, hd, lengths, kvh=2, ps=16, seed=11, extra_pages=1):
    """A pool holding each sequence on scattered pages (+ the null page, and
    spare pages past the longest sequence so the table's span exceeds it),
    q (B, KVH * G, hd) and cur_len."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = len(lengths)
    npg = -(-max(lengths) // ps) + extra_pages
    n_pages = b * npg + 1
    pool = kv_quantize(torch.randn((n_pages, ps, kvh, hd), generator=gen, device=device))
    pool += kv_quantize(torch.randn((n_pages, ps, kvh, hd), generator=gen, device=device))
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm.reshape(b, npg).to(torch.int32).to(device)
    q = torch.randn((b, kvh * g, hd), generator=gen, device=device)
    cur = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, pool, table, cur


def _contiguous(pool, table):
    """Each sequence's pages gathered into a (B, NP * ps, KVH, x) cache."""
    return [ref._gathered(x, table).contiguous() for x in pool]


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", _HEADS)
def test_cuda_split_attention_matches_plain(cuda_device, g, hd):
    """K3, K4 and K5 (T = 3) within rtol = atol = 1e-4 of their plain
    versions at lengths 1, 15, 16, 17, around a split and over several
    splits (tensor-core products of exact bf16 K/V with q and P split into
    high and low bf16 parts, base-2 exponentials, another summation order)."""
    q, pool, table, cur = _long_fixture(cuda_device, g, hd, _LENGTHS)
    got = paged_kv_attention_cuda(q, *pool, table, cur, check_pages=True)
    torch.testing.assert_close(got, ref.paged_kv_attention_ref(q, *pool, table, cur), rtol=1e-4, atol=1e-4)
    caches = _contiguous(pool, table)
    got = razer_kv_attention_cuda(q, *caches, cur)
    torch.testing.assert_close(got, ref.razer_kv_attention_ref(q, *caches, cur), rtol=1e-4, atol=1e-4)
    qt = torch.randn((len(_LENGTHS), 3, *q.shape[1:]), generator=torch.Generator(device=cuda_device).manual_seed(g),
                     device=cuda_device)
    committed = (cur - 3).clamp(min=0)
    got = paged_kv_attention_verify_cuda(qt, *pool, table, committed, check_pages=True)
    torch.testing.assert_close(got, ref.paged_kv_attention_verify_ref(qt, *pool, table, committed),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", [(3, 128), (6, 128), (8, 64)])
def test_cuda_split_attention_bit_identities(cuda_device, g, hd):
    """At multi-split lengths: K4 == K3 on the gathered bytes, and K5's query
    t at committed length c == K4 at c + t + 1, bit for bit, where the T
    queries' lengths straddle a split boundary."""
    lengths = [_SPLIT - 2, 2 * _SPLIT - 1, 2 * _SPLIT + 1, 3 * _SPLIT + 40]
    q, pool, table, cur = _long_fixture(cuda_device, g, hd, lengths, seed=12)
    assert torch.equal(paged_kv_attention_cuda(q, *pool, table, cur),
                       razer_kv_attention_cuda(q, *_contiguous(pool, table), cur))
    qt = torch.randn((len(lengths), 3, *q.shape[1:]), generator=torch.Generator(device=cuda_device).manual_seed(7),
                     device=cuda_device)
    committed = cur - 2  # query t at c + t + 1: the last split boundary falls between the queries
    got = paged_kv_attention_verify_cuda(qt, *pool, table, committed)
    for t in range(3):
        assert torch.equal(got[:, t], paged_kv_attention_cuda(qt[:, t].contiguous(), *pool, table, committed + t + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K4", "K5"])
def test_cuda_split_attention_is_batch_invariant(cuda_device, kernel):
    """A sequence's output is bit for bit the same alone and inside a batch
    of 16 with other lengths and a wider page table: the split cut depends
    on its length alone."""
    lengths = [3 * _SPLIT + 40] + [1, 17, 90, _SPLIT - 1, _SPLIT, _SPLIT + 44, 2 * _SPLIT - 1, 2 * _SPLIT + 1,
                                   700, 1000, 1100, 6 * _SPLIT, 64, 2, 1400]
    q, pool, table, cur = _long_fixture(cuda_device, 3, 128, lengths, seed=13, extra_pages=3)
    npg_alone = -(-lengths[0] // 16)
    alone_table = table[:1, :npg_alone].contiguous()
    if kernel == "K5":
        qt = torch.randn((16, 3, *q.shape[1:]), generator=torch.Generator(device=cuda_device).manual_seed(3),
                         device=cuda_device)
        committed = (cur - 3).clamp(min=0)
        batch = paged_kv_attention_verify_cuda(qt, *pool, table, committed)[:1]
        alone = paged_kv_attention_verify_cuda(qt[:1].contiguous(), *pool, alone_table, committed[:1])
    elif kernel == "K4":
        batch = paged_kv_attention_cuda(q, *pool, table, cur)[:1]
        alone = paged_kv_attention_cuda(q[:1].contiguous(), *pool, alone_table, cur[:1])
    else:
        caches = _contiguous(pool, table)
        batch = razer_kv_attention_cuda(q, *caches, cur)[:1]
        alone = razer_kv_attention_cuda(q[:1].contiguous(), *(c[:1, :npg_alone * 16].contiguous() for c in caches),
                                        cur[:1])
    assert torch.equal(batch, alone)


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd,t", [(8, 64, 5), (6, 128, 7), (3, 128, 11)])
def test_cuda_verify_beyond_one_block_of_rows_equals_decode_bitwise(cuda_device, g, hd, t):
    """T * G above a block's 32 rows (speculate_k >= 5 on dbrx's G = 6): K5
    launches once per 32 // G queries, each query within 1e-4 of the plain
    version and bit for bit K4 at committed + t + 1."""
    lengths = [_SPLIT - 4, 2 * _SPLIT + 3, 3 * _SPLIT + 40]
    q, pool, table, cur = _long_fixture(cuda_device, g, hd, lengths, seed=14, extra_pages=2)
    qt = torch.randn((len(lengths), t, *q.shape[1:]), generator=torch.Generator(device=cuda_device).manual_seed(5),
                     device=cuda_device)
    committed = cur - t // 2  # the later queries cross a split edge
    before = paged_kv_attention_verify_cuda.launches
    got = paged_kv_attention_verify_cuda(qt, *pool, table, committed, check_pages=True)
    assert paged_kv_attention_verify_cuda.launches - before == -(-t // (32 // g))
    torch.testing.assert_close(got, ref.paged_kv_attention_verify_ref(qt, *pool, table, committed),
                               rtol=1e-4, atol=1e-4)
    for i in range(t):
        assert torch.equal(got[:, i], paged_kv_attention_cuda(qt[:, i].contiguous(), *pool, table, committed + i + 1))


# --- the fused activation fake-quant in K1 / K7's x load ----------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 12, 128, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("svs", _ACT_SVS)
def test_cuda_fused_act_matmul_equals_k2_then_k1(cuda_device, m, dtype, svs):
    """K1 and K7 fake-quantizing x in their own load return the bits of K2
    followed by K1 / K7 on K2's output, bit for bit, for bf16 and f32 x (f32
    quantized before its bf16 rounding); the launch counts say which path
    ran.  K 3072 over 8 splits gives 6 steps a split: at M 128 and 1024
    (128-token tiles) more than the quantized-x region holds at once, so
    the block quantizes chunk after chunk."""
    from repro_torch.core.packing import take_shard

    g = torch.Generator(device=cuda_device).manual_seed(m + len(svs))
    pw = pack_weight(torch.randn((3072, 1024), generator=g, device=cuda_device) / 3072**0.5)
    x = _act_x(cuda_device, m, 3072, dtype, seed=m)
    m0, m1 = pw.sv_magnitudes
    two = razer_matmul_cuda(razer_act_qdq_cuda(x, svs), pw.codes, pw.scale_meta, m0=m0, m1=m1)
    before = (razer_matmul_cuda.fused_act_launches, razer_act_qdq_cuda.launches)
    fused = razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=m0, m1=m1, act_svs=svs, fused=True)
    assert (razer_matmul_cuda.fused_act_launches, razer_act_qdq_cuda.launches) == (before[0] + 1, before[1])
    assert torch.equal(fused, two)
    assert torch.equal(razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=m0, m1=m1, act_svs=svs, fused=False), two)
    shard = take_shard(pw, tp=2, tp_index=1)
    xs = x[:, 1536:].contiguous()
    two = razer_matmul_kshard_cuda(razer_act_qdq_cuda(xs, svs), shard.codes, shard.scale_meta, m0=m0, m1=m1,
                                   out_chunks=2)
    got = razer_matmul_kshard_cuda(xs, shard.codes, shard.scale_meta, m0=m0, m1=m1, out_chunks=2, act_svs=svs,
                                   fused=True)
    assert torch.equal(got, two)


@pytest.mark.cuda
def test_cuda_fused_act_follows_the_launch_plan(cuda_device):
    """Without an override the wrapper fuses at decode-sized M and launches
    K2 first above it (``launch_plan(...).fuse_act``)."""
    from repro_torch.kernels.razer_matmul import FUSE_ACT_MAX_M

    g = torch.Generator(device=cuda_device).manual_seed(3)
    pw = pack_weight(torch.randn((512, 256), generator=g, device=cuda_device))
    for m, fuses in ((FUSE_ACT_MAX_M, True), (FUSE_ACT_MAX_M + 1, False)):
        x = _act_x(cuda_device, m, 512, torch.bfloat16, seed=m)
        before = (razer_matmul_cuda.fused_act_launches, razer_act_qdq_cuda.launches)
        razer_matmul_cuda(x, pw.codes, pw.scale_meta, m0=5.0, m1=8.0, act_svs=(5.0, -5.0))
        after = (razer_matmul_cuda.fused_act_launches, razer_act_qdq_cuda.launches)
        assert after == ((before[0] + 1, before[1]) if fuses else (before[0], before[1] + 1)), m


# --- prefill attention (K9) -------------------------------------------------------------------------
_PROMPT_LENS = (8, 15, 23, 32, 40, 57, 64, 100)  # chip_smoke.py phase 4c's requests


def _bucket(n):
    return max(8, 1 << (n - 1).bit_length())


def _prefill_inputs(device, b, s, h, kvh, hd, kv_dtype, seed, skv=None):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=g, device=device).to(torch.bfloat16)
    k = torch.randn((b, skv or s, kvh, hd), generator=g, device=device).to(kv_dtype)
    v = torch.randn((b, skv or s, kvh, hd), generator=g, device=device).to(kv_dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", [(1, 16), (3, 64), (3, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_offset", [0, 40])
def test_cuda_prefill_attention_matches_plain(cuda_device, g, hd, dtype, q_offset):
    """K9 against its plain version with q, K and V in ``dtype``: f32 within
    rtol = atol = 1e-5 (expf and another summation order); bf16 within two
    bf16 ulps of the output plus 2^-9 (P is rounded to bf16 in both, and an
    f32 ulp of p can move that rounding)."""
    q, k, v = _prefill_inputs(cuda_device, 2, 70, 2 * g, 2, hd, dtype, seed=hd + q_offset, skv=70 + q_offset)
    q = q.to(dtype)
    got = prefill_attention_cuda(q, k, v, causal=True, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-9)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefill_attention_alone_equals_batched(cuda_device, kv_dtype):
    """A prompt's rows alone at its own bucket equal its rows inside a batch
    of 8 at the 128-token bucket, bit for bit (llama3_2_3b heads; K/V f32
    as prefill(qdq_kv=True) gives them, and bf16); and a continuation's
    suffix rows (q_offset 40 over 40 cached keys and its bucket) equal the
    same rows of the whole prompt's prefill."""
    q, k, v = _prefill_inputs(cuda_device, 8, 128, 24, 8, 128, kv_dtype, seed=5)
    batched = prefill_attention_cuda(q, k, v)
    for r, n in enumerate(_PROMPT_LENS):
        s = _bucket(n)
        alone = prefill_attention_cuda(q[r:r + 1, :s].contiguous(), k[r:r + 1, :s].contiguous(),
                                       v[r:r + 1, :s].contiguous())
        assert torch.equal(alone[0, :n], batched[r, :n]), n
    c, n = 40, _PROMPT_LENS[6]  # request 6 shares its first 40 tokens with request 5
    s = _bucket(n - c)
    kv = [torch.zeros((1, 64 + s, 8, 128), dtype=kv_dtype, device=cuda_device) for _ in range(2)]
    for buf, src in zip(kv, (k, v)):
        buf[0, :n] = src[6, :n]
    sfx = prefill_attention_cuda(q[6:7, c:c + s].contiguous(), *kv, q_offset=c)
    assert torch.equal(sfx[0, :n - c], batched[6, c:n])


def _wire_kv(device, b, s, kvh, hd, seed):
    """K and V as prefill's ``_qdq_kv`` gives them: random values through the
    KV wire format and back (f32, every value exact in bf16)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [kv_dequantize(*kv_quantize(torch.randn((b, s, kvh, hd), generator=g, device=device)), hd)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("g,hd", [(1, 16), (3, 32), (4, 64), (3, 128), (6, 128)])
@pytest.mark.parametrize("sq,q_offset", [(70, 0), (8, 40), (37, 1000)])
def test_cuda_prefill_attention_wire_kv_matches_plain(cuda_device, g, hd, sq, q_offset):
    """The serving path's regime: q bf16 with K/V from the KV wire format
    (f32, exact in bf16), against the plain version within the f32-K/V
    tolerance of ``chip_smoke.py``'s PREFILL_TOL (rtol 2^-7, atol 1e-6: one
    bf16 ulp of the output, where the f32 values before the cast may fall on
    the two sides of a rounding edge)."""
    q, _, _ = _prefill_inputs(cuda_device, 2, sq, 2 * g, 2, hd, torch.bfloat16, seed=hd + sq)
    k, v = _wire_kv(cuda_device, 2, sq + q_offset, 2, hd, seed=hd + sq + 1)
    got = prefill_attention_cuda(q, k, v, causal=True, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, causal=True, q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("k_dtype,v_dtype", [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_cuda_prefill_attention_mixed_kv_dtypes_match_plain(cuda_device, k_dtype, v_dtype):
    """q bf16 with K and V in different dtypes (the split writes low tiles
    for the f32 one only): against the plain version within the tolerance
    of V's dtype, which decides whether P is rounded to bf16 (rtol 2^-7;
    atol 1e-6 with f32 V, 2^-9 with bf16 V)."""
    q, k, _ = _prefill_inputs(cuda_device, 2, 70, 6, 2, 128, k_dtype, seed=31)
    _, _, v = _prefill_inputs(cuda_device, 2, 70, 6, 2, 128, v_dtype, seed=32)
    got = prefill_attention_cuda(q, k, v)
    want = ref.chunked_attention_ref(q, k, v)
    atol = 1e-6 if v_dtype == torch.float32 else 2**-9
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["wire", "f32"])
def test_cuda_prefill_attention_long_alone_equals_batched(cuda_device, kv):
    """A 3000-token prompt alone at the 4096 bucket (other values in its
    padding) equals its rows inside B 2 x 4096, bit for bit (llama3_2_3b
    heads; K/V from the wire format, which skips the low-part MMAs, and
    random f32, which takes them); and a continuation's rows at q_offset
    1000 (not a multiple of 16 or 64: rows move to other fragment slots)
    over [the 1000 cached keys, padded to 1008 | its 2048 bucket] equal
    the same rows of the whole prompt."""
    n, s, c = 3000, 4096, 1000
    q, k, v = _prefill_inputs(cuda_device, 2, s, 24, 8, 128, torch.float32, seed=7)
    if kv == "wire":
        k, v = _wire_kv(cuda_device, 2, s, 8, 128, seed=8)
    batched = prefill_attention_cuda(q, k, v)
    pq, pk, pv = _prefill_inputs(cuda_device, 1, s, 24, 8, 128, torch.float32, seed=9)
    alone_in = [torch.cat([t[:1, :n], pad[:, n:]], dim=1) for t, pad in ((q, pq), (k, pk), (v, pv))]
    alone = prefill_attention_cuda(*alone_in)
    assert torch.equal(alone[0, :n], batched[0, :n])
    sb = _bucket(n - c)
    buf = [torch.zeros((1, 1008 + sb, 8, 128), dtype=torch.float32, device=cuda_device) for _ in range(2)]
    for b_, src in zip(buf, (k, v)):
        b_[0, :n] = src[0, :n]
    sfx = prefill_attention_cuda(q[0:1, c:c + sb].contiguous(), *buf, q_offset=c)
    assert torch.equal(sfx[0, :n - c], batched[0, c:n])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["wire", "f32"])
def test_cuda_prefill_attention_long_matches_plain(cuda_device, kv):
    """B 1 x 4096 at llama3_2_3b heads (64 query blocks, the heaviest first,
    each walking up to 64 chunks through the ring) against the plain version
    within PREFILL_TOL's f32-K/V tolerance (rtol 2^-7, atol 1e-6); K/V from
    the wire format (the main path's: hi tiles only) and random f32 (every
    chunk takes the low-part MMAs)."""
    q, k, v = _prefill_inputs(cuda_device, 1, 4096, 24, 8, 128, torch.float32, seed=11)
    if kv == "wire":
        k, v = _wire_kv(cuda_device, 1, 4096, 8, 128, seed=12)
    got = prefill_attention_cuda(q, k, v)
    want = ref.chunked_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,q_offset", [(2048, 0), (1048, 1000)])
def test_cuda_prefill_attention_gapped_low_chunks_match_plain(cuda_device, sq, q_offset):
    """Wire K/V in which a few 64-key chunks, with unflagged chunks between
    them, hold random f32 values (K in chunks 1, 4, 9; V in 4, 12, 13, 30):
    the low tiles are loaded for the flagged chunks only, skipping those
    between, and the result is held against the plain version within
    PREFILL_TOL's f32-K/V tolerance (rtol 2^-7, atol 1e-6)."""
    skv = sq + q_offset
    q, _, _ = _prefill_inputs(cuda_device, 2, sq, 24, 8, 128, torch.bfloat16, seed=13)
    k, v = _wire_kv(cuda_device, 2, skv, 8, 128, seed=14)
    g = torch.Generator(device=cuda_device).manual_seed(15)
    for t, chunks in ((k, (1, 4, 9)), (v, (4, 12, 13, 30))):
        for c in chunks:
            t[:, 64 * c:64 * (c + 1)] = torch.randn((2, 64, 8, 128), generator=g, device=cuda_device)
    got = prefill_attention_cuda(q, k, v, q_offset=q_offset)
    want = ref.chunked_attention_ref(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-6)


# --- RMSNorm (K10) ----------------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 3072])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_rms_norm_matches_plain(cuda_device, d, dtype):
    """K10 against its plain version: bf16 within one bf16 ulp of the
    output, f32 within 1e-5 relative (rsqrtf and the sum's order differ)."""
    from repro_torch.kernels.rms_norm import rms_norm_cuda

    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = (torch.randn((3, 37, d), generator=g, device=cuda_device) * 3).to(dtype)
    gamma = torch.randn(d, generator=g, device=cuda_device) * 0.1
    got, want = rms_norm_cuda(x, gamma, 1e-5), ref.rms_norm_ref(x, gamma, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    tol = dict(rtol=2**-7, atol=1e-6) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_cuda_rms_norm_rows_do_not_move_with_the_batch(cuda_device):
    """A prompt's rows alone at its bucket equal its rows inside a batch of 8
    at the 128-token bucket, and 4 decode rows equal the same rows of 8, bit
    for bit."""
    from repro_torch.kernels.rms_norm import rms_norm_cuda

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn((8, 128, 3072), generator=g, device=cuda_device) * 3).to(torch.bfloat16)
    gamma = torch.randn(3072, generator=g, device=cuda_device) * 0.1
    whole = rms_norm_cuda(x, gamma)
    for r, n in enumerate(_PROMPT_LENS):
        assert torch.equal(rms_norm_cuda(x[r:r + 1, :_bucket(n)], gamma)[0, :n], whole[r, :n]), n
    xd = x[:, -1:].contiguous()
    assert torch.equal(rms_norm_cuda(xd[:4], gamma), rms_norm_cuda(xd, gamma)[:4])
