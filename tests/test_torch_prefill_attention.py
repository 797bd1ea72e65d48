"""Prefill attention (K9's plain version), the fused W4A4 dispatch and its
tables, on the CPU, against the JAX package.

The card runs the prefill kernel and the fused activation path; here the
port's plain versions run, and are held against the JAX ``chunked_attention``
and ``qlinear`` on numpy inputs from a seed.  ``test_torch_cuda.py`` holds
the kernels against the same plain versions on a card.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_weight as jax_pack_weight
from repro.core.policy import QuantPolicy as JaxQuantPolicy
from repro.core.policy import TensorSpec as JaxTensorSpec
from repro.core.qlinear import qdq_activation as jax_qdq_activation
from repro.core.qlinear import qlinear as jax_qlinear
from repro.models.attention import chunked_attention as jax_chunked_attention
from repro_torch.bridge import packed_from_numpy
from repro_torch.core.formats import round_to_values
from repro_torch.core.policy import QuantPolicy, TensorSpec
from repro_torch.core.qlinear import qdq_activation, qlinear
from repro_torch.core.razer import FP4_GRID, grid_with_sv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import razer_quantize
from repro_torch.kernels.prefill_attention import HEAD_DIMS, prefill_attention_cuda
from repro_torch.kernels.razer_matmul import FUSE_ACT_MAX_M, TOKEN_TILES, launch_plan, razer_matmul_cuda
from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda, table_numpy
from repro_torch.models.attention import chunked_attention

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return a.view(np.int32)


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def _to_jax(a: np.ndarray, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _bf16_ulp(y: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(y), 2.0**-126)))
    return 2.0 ** (e - 7)


# (B, Sq, Skv, H, KVH, hd, q_offset): GQA groups 1 and 3, hd 16 and 64, a
# prefill (Skv = Sq) and a continuation (keys before the queries)
_CASES = [(1, 8, 8, 2, 2, 16, 0), (2, 40, 40, 6, 2, 16, 0), (3, 17, 17, 3, 1, 64, 0),
          (1, 24, 64, 4, 4, 64, 40), (2, 16, 48, 6, 2, 16, 32), (3, 5, 37, 3, 3, 64, 30)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,q_offset", _CASES)
def test_prefill_attention_plain_matches_jax(b, sq, skv, h, kvh, hd, q_offset, dtype):
    """The plain version (``chunked_attention`` on the CPU) against the JAX
    ``chunked_attention``: within 1e-5 relative in f32 (the same chunks,
    sums in another order), within one bf16 ulp of the output in bf16."""
    rng = np.random.default_rng(b * 1000 + sq * 10 + hd + q_offset)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
    got = chunked_attention(_to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), causal=True,
                            q_offset=q_offset)
    want = jax_chunked_attention(_to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype), causal=True,
                                 q_offset=q_offset)
    assert got.dtype == dtype and tuple(got.shape) == (b, sq, h, hd)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_prefill_attention_dispatch_keeps_the_plain_version_on_the_cpu():
    """CPU tensors run the plain version and launch nothing; the kernel's
    wrapper refuses them."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    before = prefill_attention_cuda.launches
    y = ops.prefill_attention(q, k, v, causal=True)
    assert prefill_attention_cuda.launches == before
    assert torch.equal(y, ref.chunked_attention_ref(q, k, v, causal=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        prefill_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# the W4A4 launch choice and the fused path's tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", sorted({1, 4, 8, 12, 16, 17, 24, 32, 64, 96, 128, 129, 1024, 4096,
                                      FUSE_ACT_MAX_M, FUSE_ACT_MAX_M + 1}))
def test_fuse_choice_follows_m_alone(m):
    """``launch_plan``'s fused-activation choice is the same for every
    (N, K) at one M, and is ``M <= FUSE_ACT_MAX_M``: decode and verify
    batches fuse, prefill buckets run K2 first."""
    shapes = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072), (64, 200), (1536, 4096), (6144, 10752)]
    assert {launch_plan(1, m, n, k).fuse_act for k, n in shapes} == {m <= FUSE_ACT_MAX_M}


def test_fuse_choice_covers_the_main_paths_decode_and_verify():
    """Serving's decode batch (4 slots) and a speculate_k=2 verify pass (4 x
    3 rows) fuse; a prefill of 8 x 128 rows does not; the threshold is a
    token tile's edge, so one tile width never mixes the two paths."""
    assert launch_plan(1, 4, 3072, 3072).fuse_act and launch_plan(1, 12, 3072, 3072).fuse_act
    assert not launch_plan(1, 1024, 3072, 3072).fuse_act
    assert FUSE_ACT_MAX_M in TOKEN_TILES


@pytest.mark.parametrize("svs", [(5.0, -5.0), (5.0, -5.0, 8.0, -8.0), (-8.0, 7.5), (2.5, -7.5)])
def test_act_table_sv_capture_equals_rounding_on_the_merged_grid(svs):
    """The fused path and K2 round onto the FP4 grid with special value v
    added by two compares against the table's (lo, hi): v where lo < s <=
    hi (lo -inf for the smallest value), the FP4 rounding elsewhere.  That
    equals the plain version's rounding onto the merged grid (ties to the
    lower value) at every float32 midpoint, its neighbours and a dense
    sweep."""
    t = table_numpy(tuple(svs))
    base_mids = t[272:288]
    pts = [np.linspace(-9.0, 9.0, 20001, dtype=np.float32), np.array([-np.inf, np.inf], np.float32)]
    for g in [FP4_GRID] + [grid_with_sv(v) for v in svs]:
        mids = ((g[1:] + g[:-1]) / np.float32(2)).astype(np.float32)
        pts += [mids, np.nextafter(mids, np.float32(-np.inf)), np.nextafter(mids, np.float32(np.inf))]
    s = np.concatenate(pts).astype(np.float32)
    base = t[256:256 + len(FP4_GRID)][np.searchsorted(base_mids[np.isfinite(base_mids)], s, side="left")]
    np.testing.assert_array_equal(base, round_to_values(torch.from_numpy(s), FP4_GRID).numpy())
    for i, v in enumerate(svs):
        lo, hi = t[292 + i], t[296 + i]
        got = np.where(((lo < s) | np.isinf(lo)) & (s <= hi), np.float32(v), base)
        want = round_to_values(torch.from_numpy(s), grid_with_sv(v)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"special value {v}")


CSRC = pathlib.Path(razer_quantize.__file__).resolve().parent.parent / "csrc"


def test_act_table_layout_and_head_dims_match_the_cuda_sources():
    """The table's offsets are the header's, which the fused GEMM and K2
    read; the prefill wrapper's head widths are the ones K9 is built for."""
    src = (CSRC / "razer_act_qdq.cuh").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["SCALE_VALS"], const["SCALE_MIDS"], const["BASE_VALS"], const["BASE_MIDS"], const["SV_VALS"],
            const["SV_LO"], const["SV_HI"], const["TABLE"], const["MAX_SV"]) == (
        razer_quantize._SCALE_VALS, razer_quantize._SCALE_MIDS, razer_quantize._BASE_VALS, razer_quantize._BASE_MIDS,
        razer_quantize._SV_VALS, razer_quantize._SV_LO, razer_quantize._SV_HI, razer_quantize._TABLE,
        razer_quantize._MAX_SVS)
    kernel = (CSRC / "prefill_attention.cu").read_text()
    assert tuple(int(v) for v in re.findall(r"case (\d+): return static_cast<int>\(launch<", kernel)) == HEAD_DIMS


def test_act_table_scale_grid_and_padding():
    """The E4M3 grid (0 first, 448 last) and its float32 midpoints, padded
    with +inf so that the kernel's search by halving counts only real
    midpoints, at every midpoint and just above it; more than four special
    values are refused."""
    t = table_numpy((5.0, -5.0))
    assert t[0] == 0.0 and t[126] == 448.0 and np.isinf(t[128 + 126:256]).all()
    assert np.isfinite(t[128:128 + 126]).all() and (np.diff(t[128:128 + 126]) > 0).all()
    mids = t[128:256]
    for x in np.concatenate([mids[:126], np.nextafter(mids[:126], np.float32(np.inf)), [0.0, 1e-9, 500.0, np.inf]]):
        i, step = 0, 64  # the kernel's lower_bound by halving over the 128 padded midpoints
        while step:
            i, step = (i + step if mids[i + step - 1] < np.float32(x) else i), step // 2
        assert i == np.searchsorted(mids[:126], np.float32(x), side="left")
    with pytest.raises(ValueError, match="at most 4"):
        table_numpy((5.0, -5.0, 8.0, -8.0, 6.5))


# ---------------------------------------------------------------------------
# W4A4 qlinear on the CPU: the plain qdq, then the plain matmul
# ---------------------------------------------------------------------------
def _w4a4_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    x[0, :16] = 0.0  # an all-zero block
    x[0, 16:32] = np.array([0.0, 1.0, -1.0, 5.0, -5.0, 4.5, -4.5, 5.5] * 2, np.float32)  # ties
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jpw = jax_pack_weight(jnp.asarray(w))
    pw = packed_from_numpy(np.asarray(jpw.codes), np.asarray(jpw.scale_meta), np.asarray(jpw.tensor_scale),
                           jpw.sv_magnitudes, jpw.shape, device="cpu")
    return x, jpw, pw


@pytest.mark.parametrize("m,k,n", [(4, 64, 32), (12, 256, 64), (3, 512, 16)])
def test_w4a4_qlinear_on_the_cpu_matches_jax(m, k, n):
    """The activation spec now travels into the packed matmul; on the CPU
    that runs the plain qdq and the plain matmul, as before: the output
    equals qdq-then-matmul bit for bit, its quantized activations equal the
    JAX ``qdq_activation``'s bit for bit (zero blocks and ties included),
    and y agrees with the JAX ``qlinear`` within the f32 reduction-order
    bound of the W4 test (``test_torch_kernels.py``), and launches
    nothing."""
    x, jpw, pw = _w4a4_case(m, k, n, seed=m + k)
    pol = QuantPolicy(weight=QuantPolicy.packed().weight, act=TensorSpec.act("razer"))
    jpol = JaxQuantPolicy(weight=JaxQuantPolicy.packed().weight, act=JaxTensorSpec.act("razer"))
    xt = torch.from_numpy(x)
    before = (razer_matmul_cuda.launches, razer_act_qdq_cuda.launches)
    got = qlinear(xt, pw, pol)
    assert (razer_matmul_cuda.launches, razer_act_qdq_cuda.launches) == before
    xq = qdq_activation(xt, pol)
    np.testing.assert_array_equal(_bits(xq), _bits(np.asarray(jax_qdq_activation(jnp.asarray(x), jpol))))
    assert torch.equal(got, ref.razer_matmul_ref(xq, pw))
    want = np.asarray(jax_qlinear(jnp.asarray(x), jpw, jpol))
    bound = 1e-5 * (np.abs(xq.numpy()) @ np.abs(pw.dequantize().numpy())) + 1e-6
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_w4a4_qlinear_other_act_formats_quantize_before_the_kernel():
    """An activation spec the GEMM does not take itself (here razer with
    E3M3 scales) is applied through its format's act path first: the same
    result as quantizing x, then the W4 matmul."""
    x, _, pw = _w4a4_case(4, 64, 32, seed=3)
    act = TensorSpec.act("razer", scale_fmt="e3m3")
    pol = QuantPolicy(weight=QuantPolicy.packed().weight, act=act)
    xt = torch.from_numpy(x)
    assert torch.equal(qlinear(xt, pw, pol), ops.razer_matmul(act.qdq(xt, axis=-1), pw))


@pytest.mark.parametrize("block", [32, 64])
def test_w4a4_qlinear_other_block_sizes_travel_into_the_matmul(block):
    """A razer E4M3 activation spec of another block size also goes to the
    packed matmul with its block (the card's kernels take 16 only): on the
    CPU the plain qdq in that block, then the plain matmul, and its
    quantized activations equal the JAX ``qdq_activation``'s bit for bit."""
    x, _, pw = _w4a4_case(4, 256, 32, seed=block)
    pol = QuantPolicy(weight=QuantPolicy.packed().weight, act=TensorSpec.act("razer", block_size=block))
    jpol = JaxQuantPolicy(weight=JaxQuantPolicy.packed().weight, act=JaxTensorSpec.act("razer", block_size=block))
    xt = torch.from_numpy(x)
    xq = ref.razer_act_qdq_ref(xt, svs=pol.act.special_values, block=block)
    np.testing.assert_array_equal(_bits(xq), _bits(np.asarray(jax_qdq_activation(jnp.asarray(x), jpol))))
    assert torch.equal(qlinear(xt, pw, pol), ref.razer_matmul_ref(xq, pw))
