"""The port's serving-mesh pieces against the JAX package's, in one process on
the CPU: the divisibility validators and their error texts, the eligibility
decisions of K-sharding and expert sharding (``packed_weight_specs`` /
``stacked_bank_specs`` on the same shapes and mesh sizes), rank (i, j)'s
wire bytes, each rank's plain partial product against the Pallas K-shard
kernels in interpret mode (float32, 1e-5: summation order), the dispatch
group count under a mesh, and the wire bytes of the quantized all-gather.

The reference's decisions read only a mesh's axis names and sizes, so a
stand-in object with those two attributes gives them any (ep, tp) here,
with the one host device this process has.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jax_packing
from repro.core.packing import pack_stacked_weights as jax_pack_stacked
from repro.core.packing import pack_weight as jax_pack_weight
from repro.kernels.razer_grouped_matmul import razer_grouped_matmul_kshard_pallas
from repro.kernels.razer_matmul import razer_matmul_kshard_pallas
from repro.models import moe as jax_moe
from repro.parallel import collectives as jax_coll
from repro.parallel import sharding as jax_sharding
from repro_torch.bridge import packed_from_numpy, packed_stacked_from_numpy
from repro_torch.core.packing import (PackedRazerWeight, PackedStackedTensor, pack_fp4_codes, pack_scale_meta,
                                      take_shard)
from repro_torch.core.formats import FP4_NEG_ZERO_CODE, fp4_encode
from repro_torch.core.razer import razer_quantize, sv_pairs_to_set
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.parallel import collectives, sharding

MATMUL_TOL = 1e-5  # f32 sums in another order


@dataclasses.dataclass
class _AxesOnly:
    """What the reference's ``_Ctx`` reads of a mesh: axis names and sizes."""

    shape: dict
    axis_names: tuple = ("data", "model")


def _ref_ctx(ep, tp):
    return jax_sharding._Ctx(_AxesOnly({"data": ep, "model": tp}))


def _port_mesh(ep, tp, i=0, j=0):
    return sharding.ServingMesh(ep=ep, tp=tp, data_index=i, model_index=j, device=torch.device("cpu"),
                                backend="gloo")


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


def _w(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _zeros_packed(k, n):
    """A JAX container of shape (K, N) with zero bytes: the decisions read
    shapes only, and eager packing would compile once per shape."""
    return jax_packing.PackedRazerWeight(np.zeros((k // 2, n), np.uint8), np.zeros((k // 16, n), np.uint8),
                                         np.float32(1.0), (5.0, 8.0), (k, n))


def _zeros_stacked(e, k, n):
    return jax_packing.PackedStackedTensor(np.zeros((e, k // 2, n), np.uint8), np.zeros((e, k // 16, n), np.uint8),
                                           np.ones(e, np.float32), (5.0, 8.0), (e, k, n))


def _port(jp):
    return packed_from_numpy(jp.codes, jp.scale_meta, jp.tensor_scale, jp.sv_magnitudes, jp.shape, device="cpu")


def _port_stacked(jp):
    return packed_stacked_from_numpy(jp.codes, jp.scale_meta, jp.tensor_scale, jp.sv_magnitudes, jp.shape,
                                     device="cpu")


@pytest.mark.parametrize("k, tp", [(64, 2), (48, 2), (96, 3), (3072, 2), (3072, 4), (8192, 4), (10752, 2),
                                   (16, 2), (64, 0), (64, -1)])
def test_kshard_size_matches_reference(k, tp):
    assert _outcome(sharding.kshard_size, k, tp) == _outcome(jax_sharding.kshard_size, k, tp)


@pytest.mark.parametrize("e, ep", [(16, 2), (16, 3), (4, 4), (4, 8), (8, 0)])
def test_expert_shard_size_matches_reference(e, ep):
    assert _outcome(sharding.expert_shard_size, e, ep) == _outcome(jax_sharding.expert_shard_size, e, ep)


@pytest.mark.parametrize("k, n, tp", [(64, 32, 2), (48, 32, 2), (64, 30, 2), (64, 32, 1), (96, 48, 3),
                                      (128, 32, 4), (64, 32, 4)])
@pytest.mark.parametrize("strict", [False, True])
def test_packed_weight_decision_matches_reference(k, n, tp, strict):
    """K-sharded exactly when the reference's specs exist, and the same
    strict errors; ``local_shard`` refuses what the reference refuses."""
    jp = _zeros_packed(k, n)
    want = _outcome(jax_sharding.packed_weight_specs, jp, _ref_ctx(1, tp), strict=strict)
    got = _outcome(sharding.packed_weight_shards, _port(jp), _port_mesh(1, tp), strict=strict)
    if want[0] == "error":
        assert got == want
    else:
        assert got == ("ok", 1 if want[1] is None else tp)
    assert _outcome(lambda: _port(jp).local_shard(tp).shape) == _outcome(lambda: jp.local_shard(tp).shape)


@pytest.mark.parametrize("e, k, ep, tp", [(4, 64, 2, 1), (4, 64, 2, 2), (4, 48, 2, 2), (4, 64, 3, 1),
                                          (4, 64, 1, 2), (6, 96, 3, 3), (4, 64, 1, 1)])
@pytest.mark.parametrize("strict", [False, True])
def test_stacked_bank_decision_matches_reference(e, k, ep, tp, strict):
    """(expert shards, K shards) exactly when the reference's bank specs
    exist and split the wire rows on "model"; the same strict errors and
    ``local_shard`` errors."""
    jp = _zeros_stacked(e, k, 32)
    want = _outcome(jax_sharding.stacked_bank_specs, jp, _ref_ctx(ep, tp), strict=strict)
    got = _outcome(sharding.stacked_bank_shards, _port_stacked(jp), _port_mesh(ep, tp), strict=strict)
    if want[0] == "error":
        assert got == want
    elif want[1] is None:
        assert got == ("ok", None)
    else:
        k_split = want[1].codes[1] == "model"
        assert got == ("ok", (ep, tp if k_split else 1))
    assert (_outcome(lambda: _port_stacked(jp).local_shard(ep, tp).shape)
            == _outcome(lambda: jp.local_shard(ep, tp).shape))


def _pack_with_scale(w: np.ndarray, tensor_scale: torch.Tensor):
    """The port's ``pack_weight`` bytes of ``w`` under a given tensor scale."""
    k, n = w.shape
    bq = razer_quantize(torch.from_numpy(w), special_values=sv_pairs_to_set(5.0, 8.0), block_size=16,
                        scale_fmt="e3m3", axis=0, tensor_scale=tensor_scale)
    q = bq.q
    uses_sv = (bq.sv_index >= 0)[..., None] & (q == bq.sv[..., None])
    codes = torch.where(uses_sv, torch.full_like(q, FP4_NEG_ZERO_CODE, dtype=torch.uint8), fp4_encode(q))
    return (pack_fp4_codes(codes.reshape(n, k)).T.contiguous(),
            pack_scale_meta(bq.block_scale, bq.sv_index, weight=True).T.contiguous())


@pytest.mark.parametrize("tp", [2, 4])
def test_take_shard_bytes_match_reference_rows(tp):
    """Rank j's K/tp shard: the JAX container's wire rows j, and the bytes of
    packing that K slice directly under the whole weight's tensor scale."""
    k, n = 128, 48
    w = _w((k, n), 5, scale=2.0)
    jp = jax_pack_weight(jnp.asarray(w))
    pw = _port(jp)
    kl = k // tp
    for j in range(tp):
        local = take_shard(pw, tp=tp, tp_index=j)
        assert isinstance(local, PackedRazerWeight) and local.shape == (kl, n) and local.k_shards == tp
        np.testing.assert_array_equal(local.codes.numpy(), np.asarray(jp.codes)[j * kl // 2:(j + 1) * kl // 2])
        np.testing.assert_array_equal(local.scale_meta.numpy(),
                                      np.asarray(jp.scale_meta)[j * kl // 16:(j + 1) * kl // 16])
        codes, meta = _pack_with_scale(w[j * kl:(j + 1) * kl], pw.tensor_scale)
        assert torch.equal(local.codes, codes) and torch.equal(local.scale_meta, meta)
        np.testing.assert_array_equal(local.dequantize().numpy(), np.asarray(jp.dequantize())[j * kl:(j + 1) * kl])
    with pytest.raises(ValueError, match="shard of one"):
        take_shard(take_shard(pw, tp=tp, tp_index=0), tp=tp)


@pytest.mark.parametrize("ep, tp", [(2, 1), (1, 2), (2, 2)])
def test_take_shard_bank_tiles_match_reference(ep, tp):
    e, k, n = 4, 64, 32
    w = _w((e, k, n), 6)
    jp = jax_pack_stacked(jnp.asarray(w))
    pst = _port_stacked(jp)
    le, kl = e // ep, k // tp
    for i in range(ep):
        for j in range(tp):
            tile = take_shard(pst, ep=ep, ep_index=i, tp=tp, tp_index=j)
            assert isinstance(tile, PackedStackedTensor) and tile.shape == (le, kl, n)
            assert (tile.e_shards, tile.k_shards) == (ep, tp)
            ex = slice(i * le, (i + 1) * le)
            np.testing.assert_array_equal(tile.codes.numpy(),
                                          np.asarray(jp.codes)[ex, j * kl // 2:(j + 1) * kl // 2])
            np.testing.assert_array_equal(tile.scale_meta.numpy(),
                                          np.asarray(jp.scale_meta)[ex, j * kl // 16:(j + 1) * kl // 16])
            np.testing.assert_array_equal(tile.tensor_scale.numpy(), np.asarray(jp.tensor_scale)[ex])
            for le_i in range(le):
                codes, meta = _pack_with_scale(w[i * le + le_i, j * kl:(j + 1) * kl], tile.tensor_scale[le_i])
                assert torch.equal(tile[le_i].codes, codes) and torch.equal(tile[le_i].scale_meta, meta)


@pytest.mark.parametrize("tp", [2, 4])
def test_plain_partial_matches_pallas_kshard(tp):
    """Each rank's plain partial (the CPU route of K7 before its exchange)
    against ``razer_matmul_kshard_pallas(axis_name=None)`` in interpret mode
    on the same local shard, and the chunk-major layout its epilogue
    hands the reduce-scatter."""
    k, n, m = 256, 64, 5
    jp = jax_pack_weight(jnp.asarray(_w((k, n), 7, scale=k**-0.5)))
    pw = _port(jp)
    x = _w((m, k), 8)
    kl = k // tp
    total = np.zeros((m, n), np.float32)
    for j in range(tp):
        local = take_shard(pw, tp=tp, tp_index=j)
        xl = x[:, j * kl:(j + 1) * kl]
        xp = np.zeros((16, kl), np.float32)
        xp[:m] = xl
        pallas = razer_matmul_kshard_pallas(jnp.asarray(xp), jnp.asarray(local.codes.numpy()),
                                            jnp.asarray(local.scale_meta.numpy()), m0=5.0, m1=8.0, axis_name=None,
                                            block_m=16, block_n=n, block_k=64, compute_dtype=jnp.float32,
                                            interpret=True)
        want = np.asarray(pallas)[:m] * float(jp.tensor_scale)
        got = ref.razer_matmul_ref(torch.from_numpy(xl), local)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_TOL)
        chunks = ops._chunked(got, tp)
        assert chunks.shape == (tp, m, n // tp)
        for r in range(tp):
            assert torch.equal(chunks[r], got[:, r * n // tp:(r + 1) * n // tp])
        total += got.numpy()
    np.testing.assert_allclose(total, x @ np.asarray(jp.dequantize()), rtol=0, atol=MATMUL_TOL)


@pytest.mark.parametrize("ep, tp", [(2, 2), (1, 2)])
def test_grouped_plain_partial_matches_pallas_kshard(ep, tp):
    e, k, n, m = 4, 128, 32, 6
    jp = jax_pack_stacked(jnp.asarray(_w((e, k, n), 9, scale=k**-0.5)))
    pst = _port_stacked(jp)
    x = _w((e, m, k), 10)
    le, kl = e // ep, k // tp
    for i in range(ep):
        for j in range(tp):
            tile = take_shard(pst, ep=ep, ep_index=i, tp=tp, tp_index=j)
            xl = np.zeros((le, 16, kl), np.float32)
            xl[:, :m] = x[i * le:(i + 1) * le, :, j * kl:(j + 1) * kl]
            pallas = razer_grouped_matmul_kshard_pallas(
                jnp.asarray(xl), jnp.asarray(tile.codes.numpy()), jnp.asarray(tile.scale_meta.numpy()), m0=5.0,
                m1=8.0, axis_name=None, block_m=16, block_n=n, block_k=64, compute_dtype=jnp.float32,
                interpret=True)
            want = np.asarray(pallas)[:, :m] * tile.tensor_scale.numpy()[:, None, None]
            got = ref.razer_grouped_matmul_ref(torch.from_numpy(xl[:, :m]), tile)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_TOL)


@pytest.mark.parametrize("ep, tp", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 2), (3, 1)])
def test_pick_groups_matches_reference_under_mesh(ep, tp):
    for t in (1, 2, 3, 4, 5, 6, 8, 12, 16, 25, 48, 128):
        with jax_sharding.sharding_ctx(_AxesOnly({"data": ep, "model": tp})):
            want = jax_moe._pick_groups(t)
        with sharding.sharding_ctx(_port_mesh(ep, tp)):
            got = moe._pick_groups(t)
        assert got == want, (t, ep, tp)
        assert moe._pick_groups(t) == jax_moe._pick_groups(t)  # meshless: gcd(t, 16)


def test_wire_encode_bytes_match_reference():
    x = _w((2, 3, 32), 11, scale=3.0)
    jc, jm, jshape = jax_coll.wire_encode(jnp.asarray(x))
    codes, meta, tshape = collectives.wire_encode(torch.from_numpy(x))
    assert tshape == tuple(jshape)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(meta.numpy(), np.asarray(jm))
    want = np.asarray(jax_coll.wire_decode(jc, jm, jshape, dtype=jnp.float32))
    np.testing.assert_array_equal(collectives.wire_decode(codes, meta, tshape, dtype=torch.float32).numpy(), want)


def test_kshard_ops_refuse_a_shard_without_its_group():
    pw = take_shard(_port(_zeros_packed(64, 32)), tp=2, tp_index=0)
    with pytest.raises(ValueError, match="tp group"):
        ops.razer_matmul_kshard(torch.zeros(3, 32), pw, group=None)
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.qlinear import qlinear

    with pytest.raises(ValueError, match="sharding_ctx"):
        qlinear(torch.zeros(3, 64), pw, QuantPolicy.packed())


def test_shard_params_keeps_ineligible_and_dense_leaves():
    """On a (1, 2) mesh: K % 32 == 0 weights become K/2 shards, others and
    the dense leaves stay the very same objects."""
    from repro_torch.serving.engine import pack_model_weights
    from repro_torch.core.policy import QuantPolicy

    tree = {"embed": torch.zeros(8, 4), "layers_0": [{"mixer": {"wq": torch.from_numpy(_w((64, 32), 1)),
                                                                "wk": torch.from_numpy(_w((48, 32), 2))}}]}
    packed = pack_model_weights(tree, None, QuantPolicy.packed())
    local = sharding.shard_params(packed, _port_mesh(1, 2, j=1))
    assert local["embed"] is packed["embed"]
    wq, wk = local["layers_0"][0]["mixer"]["wq"], local["layers_0"][0]["mixer"]["wk"]
    assert wq.k_shards == 2 and wq.shape == (32, 32)
    assert torch.equal(wq.codes, packed["layers_0"][0]["mixer"]["wq"].codes[16:])
    assert wk is packed["layers_0"][0]["mixer"]["wk"]


def test_mesh_entry_points_refuse_to_run_silently_on_cpu():
    """``make_serving_mesh`` and the serve launcher default to the card and
    raise without CUDA before joining any process group."""
    if torch.cuda.is_available():
        pytest.skip("checks what happens on a machine without CUDA")
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh

    for call in (lambda: make_serving_mesh(ep=1, tp=2, backend="gloo"),
                 lambda: serve.main(["--arch", "llama3_2_3b", "--reduced", "--tp", "2", "--backend", "gloo"]),
                 lambda: serve.main(["--arch", "llama3_2_3b", "--reduced"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="tp must be positive"):
        make_serving_mesh(tp=0, device="cpu")
