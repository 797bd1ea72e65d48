"""The port's packed MoE pieces against the JAX package's, on the CPU in
float32: stacked-bank packing bytes, the grouped GEMM's plain version, the
GShard dispatch/combine with capacity drops, and ``moe_forward`` in its
packed (W4 and W4A4), dense and fakequant branches.  Inputs are made with numpy from a
seed and handed to both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import packing as jax_packing
from repro.core.packing import pack_stacked_weights as jax_pack_stacked
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.core.policy import TensorSpec as JaxSpec
from repro.kernels import ref as jax_ref
from repro.kernels.razer_grouped_matmul import razer_grouped_matmul_pallas
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.serving.engine import pack_model_weights as jax_pack_model_weights
from repro_torch.bridge import packed_stacked_from_numpy, params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor, pack_stacked_weights, pack_weight
from repro_torch.core.policy import QuantPolicy, TensorSpec
from repro_torch.kernels import ops, ref
from repro_torch.models import moe
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import pack_model_weights

MATMUL_TOL = 1e-5  # f32 sums in another order
MOE_TOL = 1e-5


def _bank(e, k, n, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((e, k, n)) * scale).astype(np.float32)


def _u8(a):
    return np.asarray(a, np.uint8)


@pytest.mark.parametrize("svs", [(5.0, 8.0), (5.0, 7.0)])
def test_pack_stacked_bytes_match_jax(svs):
    """Codes, scale/meta bytes and tensor scales equal the JAX package's, and
    each entry is ``pack_weight`` of that expert on its own."""
    w = _bank(3, 64, 48, seed=int(svs[1]), scale=2.0)
    w[1, :16, :8] = 0.0  # all-zero blocks in one entry
    jp = jax_pack_stacked(jnp.asarray(w), sv_magnitudes=svs)
    tp = pack_stacked_weights(torch.from_numpy(w), sv_magnitudes=svs)
    assert tp.shape == (3, 64, 48) and tp.codes.shape == (3, 32, 48) and tp.scale_meta.shape == (3, 4, 48)
    np.testing.assert_array_equal(tp.codes.numpy(), _u8(jp.codes))
    np.testing.assert_array_equal(tp.scale_meta.numpy(), _u8(jp.scale_meta))
    np.testing.assert_array_equal(tp.tensor_scale.numpy(), np.asarray(jp.tensor_scale, np.float32))
    np.testing.assert_array_equal(tp.dequantize().numpy(), np.asarray(jp.dequantize()))
    for e in range(3):
        pw = pack_weight(torch.from_numpy(w[e]), sv_magnitudes=svs)
        assert torch.equal(tp[e].codes, pw.codes) and torch.equal(tp[e].scale_meta, pw.scale_meta)
        assert torch.equal(tp[e].tensor_scale, pw.tensor_scale)


def test_pack_stacked_rejects_2d():
    with pytest.raises(ValueError, match="3-D"):
        pack_stacked_weights(torch.zeros(32, 16))


@pytest.mark.parametrize("m", [16, 5])  # 5: ragged rows, padded for the Pallas grid only
def test_grouped_plain_matches_pallas_interpret_and_ref(m):
    e, k, n = 3, 128, 32
    w = _bank(e, k, n, seed=11, scale=k**-0.5)  # outputs of order 1
    x = np.random.default_rng(12).standard_normal((e, m, k)).astype(np.float32)
    jp = jax_pack_stacked(jnp.asarray(w))
    pst = packed_stacked_from_numpy(jp.codes, jp.scale_meta, jp.tensor_scale, jp.sv_magnitudes, jp.shape,
                                    device="cpu")
    xp = np.zeros((e, 16, k), np.float32)
    xp[:, :m] = x
    pallas = razer_grouped_matmul_pallas(jnp.asarray(xp), jp.codes, jp.scale_meta, m0=jp.sv_magnitudes[0],
                                         m1=jp.sv_magnitudes[1], block_m=16, block_n=n, block_k=64,
                                         compute_dtype=jnp.float32, interpret=True)
    want = np.asarray(pallas)[:, :m] * np.asarray(jp.tensor_scale)[:, None, None]
    jref = np.asarray(jax_ref.razer_grouped_matmul_ref(jnp.asarray(x), jp))
    got = ref.razer_grouped_matmul_ref(torch.from_numpy(x), pst)
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MATMUL_TOL)
    np.testing.assert_allclose(got.numpy(), jref, rtol=0, atol=MATMUL_TOL)
    # the CPU route of ops: the plain version, cast to x's dtype
    assert torch.equal(ops.razer_grouped_matmul(torch.from_numpy(x), pst), got)


def _routing(g, tg, e, k, seed):
    """Distinct top-k experts per token, skewed so that capacity drops."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((g, tg, e)) + np.array([2.0, 1.0, 0.0, -1.0])[:e]
    topi = np.argsort(-logits, axis=-1)[..., :k].astype(np.int32)
    topw = rng.random((g, tg, k)).astype(np.float32)
    return topi, topw


def test_dispatch_and_combine_match_jax_with_drops():
    g, tg, d, e, k = 2, 8, 16, 4, 2
    cap = max(int(np.ceil(tg * k / e * 1.0)), 1)  # capacity factor 1.0
    xg = np.random.default_rng(3).standard_normal((g, tg, d)).astype(np.float32)
    topi, topw = _routing(g, tg, e, k, seed=4)
    jbuf, jse, jsp, jkeep, jst = jax.vmap(jax_moe._group_dispatch, in_axes=(0, 0, None, None))(
        jnp.asarray(xg), jnp.asarray(topi), e, cap)
    buf, se, sp, keep = moe._group_dispatch(torch.from_numpy(xg), torch.from_numpy(topi).long(), e, cap)
    assert not bool(keep.all()), "the routing must overflow an expert"
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(np.asarray(jst), np.broadcast_to(np.repeat(np.arange(tg), k), (g, tg * k)))

    h = np.random.default_rng(5).standard_normal((g, e, cap, d)).astype(np.float32)
    jy = jax.vmap(jax_moe._group_combine, in_axes=(0, 0, 0, 0, 0, 0, None))(
        jnp.asarray(h), jse, jsp, jkeep, jst, jnp.asarray(topw), tg)
    y = moe._group_combine(torch.from_numpy(h), se, sp, keep, torch.from_numpy(topw))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


def _moe_cfgs(shared: int, f: int = 32, capacity_factor: float = 1.25):
    kw = dict(n_shared_experts=shared, moe_d_ff=f, capacity_factor=capacity_factor, compute_dtype="float32")
    return (dataclasses.replace(get_config("dbrx_132b").reduced(), **kw),
            dataclasses.replace(torch_get_config("dbrx_132b").reduced(), **kw))


def _moe_params(jcfg, seed=0):
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _to_jax(tree):
    """The port's (packed) tree as the JAX package's, carrying the wire
    bytes over as they are (their equality is tested above)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (PackedRazerWeight, PackedStackedTensor)):
        cls = getattr(jax_packing, type(tree).__name__)
        return cls(jnp.asarray(tree.codes.numpy()), jnp.asarray(tree.scale_meta.numpy()),
                   jnp.asarray(tree.tensor_scale.numpy()), tree.sv_magnitudes, tree.shape)
    return jnp.asarray(tree.numpy())


_W4A4 = (JaxPolicy(weight=JaxPolicy.packed().weight, act=JaxSpec.act("razer")),
         QuantPolicy(weight=QuantPolicy.packed().weight, act=TensorSpec.act("razer")))
_BRANCHES = {
    "packed": (JaxPolicy.packed(), QuantPolicy.packed()),
    # the shared experts' linears see the activation fake-quant, the grouped
    # expert products do not, in both packages
    "packed_w4a4": _W4A4,
    "dense": (JaxPolicy.bf16(), QuantPolicy.bf16()),
    "fakequant": (JaxPolicy.fakequant("nvfp4"), QuantPolicy.fakequant("nvfp4")),
}


@pytest.mark.parametrize("shared", [0, 1], ids=["no_shared", "shared"])
@pytest.mark.parametrize("branch", list(_BRANCHES))
def test_moe_forward_matches_jax(branch, shared):
    """y and the aux loss within 1e-5; at capacity factor 1.25 over 3 x 8
    tokens some slots drop, the same ones in both packages."""
    jcfg, tcfg = _moe_cfgs(shared)
    jp, tp = _moe_params(jcfg)
    jpol, tpol = _BRANCHES[branch]
    if branch.startswith("packed"):
        tp = pack_model_weights(tp, tcfg, tpol)
        assert isinstance(tp["experts"]["down"], PackedStackedTensor)
        jp = _to_jax(tp)
    x = np.random.default_rng(7).standard_normal((3, 8, tcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(functools.partial(jax_moe.moe_forward, cfg=jcfg, quant=jpol))(jnp.asarray(x), jp)
    y, aux = moe.moe_forward(torch.from_numpy(x), tp, tcfg, quant=tpol)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=MOE_TOL)


def test_mixed_bank_raises():
    jcfg, tcfg = _moe_cfgs(0)
    _, tp = _moe_params(jcfg)
    tp["experts"]["gate"] = pack_stacked_weights(tp["experts"]["gate"])
    with pytest.raises(ValueError, match="gate=packed, up=dense, down=dense"):
        moe.moe_forward(torch.zeros(1, 4, tcfg.d_model), tp, tcfg, quant=QuantPolicy.packed())


def test_bank_trio_packs_all_or_none():
    """moe_d_ff = 40 is not a block multiple: gate/up (E, d, 40) reduce over
    an aligned d but down (E, 40, d) does not, so none of the three packs,
    in either package; with 32 all three do."""
    for f, packed in ((40, False), (32, True)):
        jcfg, tcfg = _moe_cfgs(0, f=f)
        jp, tp = _moe_params(jcfg)
        jpack = jax.jit(functools.partial(jax_pack_model_weights, cfg=jcfg, quant=JaxPolicy.packed()))
        jbanks = jpack(jp)["experts"]
        tbanks = pack_model_weights(tp, tcfg, QuantPolicy.packed())["experts"]
        for r in ("gate", "up", "down"):
            assert isinstance(tbanks[r], PackedStackedTensor) == packed
            assert (type(jbanks[r]).__name__ == "PackedStackedTensor") == packed


def test_bridge_carries_a_two_group_moe_tree():
    """``first_dense_layers=1``: the JAX tree's ``layers_0`` (one dense layer)
    and ``layers_1`` (the MoE layers, banks (L, E, d, f)) unstack into the
    port's per-layer lists, which ``init_params`` lays out alike."""
    kw = dict(first_dense_layers=1, n_shared_experts=1)
    jcfg = dataclasses.replace(get_config("dbrx_132b").reduced(), **kw)
    tcfg = dataclasses.replace(torch_get_config("dbrx_132b").reduced(), **kw)
    jp = jax.tree_util.tree_map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jp, device="cpu")
    own = init_params(tcfg, device="cpu")
    assert sorted(k for k in tp if k.startswith("layers_")) == ["layers_0", "layers_1"]
    assert [len(tp["layers_0"]), len(tp["layers_1"])] == [1, 2] == [len(own["layers_0"]), len(own["layers_1"])]
    assert "mlp" in tp["layers_0"][0] and "moe" not in tp["layers_0"][0]
    jmoe = jp["layers_1"]["moe"]
    for i, layer in enumerate(tp["layers_1"]):
        for r in ("gate", "up", "down"):
            np.testing.assert_array_equal(layer["moe"]["experts"][r].numpy(), jmoe["experts"][r][i])
            assert layer["moe"]["experts"][r].shape == own["layers_1"][i]["moe"]["experts"][r].shape
        np.testing.assert_array_equal(layer["moe"]["shared"]["down"].numpy(), jmoe["shared"]["down"][i])


def test_bf16_draft_casts_only_what_the_policy_quantizes():
    """The bf16 draft casts the weights the target's packed policy quantizes
    (linears, expert banks, shared experts) once; what its dense rules keep
    at high precision (embedding, head, router, norms) stays f32, so the
    draft's router runs on the f32 weights as the reference's does."""
    from repro_torch.serving.speculative import _dense_in

    cfg = dataclasses.replace(torch_get_config("dbrx_132b").reduced(), first_dense_layers=1, n_shared_experts=1)
    tree = init_params(cfg, device="cpu")
    draft = _dense_in(tree, QuantPolicy.packed(kv_quant=True), torch.bfloat16)
    dense, moe_layer = draft["layers_0"][0], draft["layers_1"][0]
    for w in (draft["embed"], draft["lm_head"], draft["final_norm"], dense["ln1"], moe_layer["moe"]["router"]):
        assert w.dtype == torch.float32
    for w in (dense["mixer"]["wq"], dense["mlp"]["down"], moe_layer["mixer"]["wo"],
              *moe_layer["moe"]["experts"].values(), moe_layer["moe"]["shared"]["gate"]):
        assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(moe_layer["moe"]["experts"]["up"].float().numpy(),
                                  tree["layers_1"][0]["moe"]["experts"]["up"].to(torch.bfloat16).float().numpy())
