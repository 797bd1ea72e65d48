"""The zoo's modules in the port against the JAX functions of the same
name, on the JAX package's weights and the same inputs, in float32: MLA's
``_mla_ckv``, ``mla_forward`` (with and without the query's low-rank
path) and ``mla_decode`` (ragged positions, the latent cache written in
place); ``apply_mrope`` with distinct t / h / w streams; ``gelu_mlp`` (the
tanh GELU ``jax.nn.gelu`` computes); whisper's ``encode`` and
``cross_forward``; GQA decode under M-RoPE with ``positions3``.  Values
within 1e-5 (float32 matmuls and transcendentals in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_cases import configs, trees
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.bridge import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

TOL = dict(rtol=0, atol=1e-5)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mixer(jcfg, init, seed=0):
    """A mixer's JAX params (numpy tree) and the port's copy."""
    tree = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module", params=[0, 16], ids=["wq", "q_lora"])
def mla(request):
    jcfg, tcfg = configs("deepseek_v2_236b", q_lora_rank=request.param)
    jp, tp = _mixer(jcfg, jattn.mla_init)
    return jcfg, tcfg, jp, tp


def test_mla_ckv_matches(mla):
    jcfg, tcfg, jp, tp = mla
    x = _rand((2, 7, jcfg.d_model), 1)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    jc, jr = jattn._mla_ckv(jnp.asarray(x), jp, jcfg, JaxPolicy.bf16(), jnp.asarray(pos))
    tc, tr = tattn._mla_ckv(torch.from_numpy(x), tp, tcfg, QuantPolicy.bf16(), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(tc), _np(jc), **TOL)
    np.testing.assert_allclose(_np(tr), _np(jr), **TOL)


@pytest.mark.parametrize("policy", ["bf16", "w4"])
def test_mla_forward_matches(mla, policy):
    """The materialized MLA prefill (the reference pads V to nope + rope and
    slices it; the port attends V at v_head_dim); under W4 the projections
    are fake-quantized, kv_b stays dense by the default rules."""
    jcfg, tcfg, jp, tp = mla
    jpol, tpol = (JaxPolicy.bf16(), QuantPolicy.bf16()) if policy == "bf16" else \
        (JaxPolicy.fakequant("razer"), QuantPolicy.fakequant("razer"))
    x = _rand((2, 9, jcfg.d_model), 2)
    want = jattn.mla_forward(jnp.asarray(x), jp, jcfg, quant=jpol)
    got = tattn.mla_forward(torch.from_numpy(x), tp, tcfg, quant=tpol)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mla_decode_matches(mla):
    """One absorbed decode step at ragged positions over a cache holding
    random latents: the output and both updated caches."""
    jcfg, tcfg, jp, tp = mla
    b, smax = 2, 12
    x = _rand((b, 1, jcfg.d_model), 3)
    c, kr = _rand((b, smax, jcfg.kv_lora_rank), 4), _rand((b, smax, jcfg.qk_rope_dim), 5)
    cur = np.array([3, 9], np.int32)
    jy, jcache = jattn.mla_decode(jnp.asarray(x), jp, jcfg, {"c": jnp.asarray(c), "kr": jnp.asarray(kr)},
                                  jnp.asarray(cur), quant=JaxPolicy.bf16())
    tcache = {"c": torch.from_numpy(c.copy()), "kr": torch.from_numpy(kr.copy())}
    ty, tcache = tattn.mla_decode(torch.from_numpy(x), tp, tcfg, tcache, torch.from_numpy(cur),
                                  quant=QuantPolicy.bf16())
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    for name in ("c", "kr"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), **TOL)


def test_apply_mrope_with_distinct_streams():
    """Temporal, height and width positions differ (an image's patches), so
    each frequency section rotates by its own stream."""
    x = _rand((2, 5, 3, 16), 6)
    rng = np.random.default_rng(7)
    pos3 = rng.integers(0, 50, (3, 2, 5)).astype(np.int32)
    assert not (pos3[0] == pos3[1]).all() and not (pos3[1] == pos3[2]).all()
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (2, 3, 3), 1e6)
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), (2, 3, 3), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sum to"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), (2, 3, 4))


def test_gqa_decode_with_positions3_matches():
    """A Qwen2-VL decode step with explicit M-RoPE streams over a bf16-layout
    cache (f32 here) at ragged lengths."""
    jcfg, tcfg = configs("qwen2_vl_7b")
    jp, tp = _mixer(jcfg, jattn.gqa_init)
    tp = {k: torch.from_numpy(np.random.default_rng(8).normal(0, 0.5, v.shape).astype(np.float32))
          if k.startswith("b") else v for k, v in tp.items()}
    jp = {k: jnp.asarray(tp[k].numpy()) for k in tp}
    b, smax, kvh, hd = 2, 10, jcfg.num_kv_heads, jcfg.hd
    x = _rand((b, 1, jcfg.d_model), 9)
    k, v = _rand((b, smax, kvh, hd), 10), _rand((b, smax, kvh, hd), 11)
    cur = np.array([4, 7], np.int32)
    pos3 = np.stack([cur, cur + 3, cur + 5])[:, :, None].astype(np.int32)  # (3, B, 1)
    jy, jc = jattn.gqa_decode(jnp.asarray(x), jp, jcfg, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                              jnp.asarray(cur), quant=JaxPolicy.bf16(), positions3=jnp.asarray(pos3))
    ty, tc = tattn.gqa_decode(torch.from_numpy(x), tp, tcfg, {"k": torch.from_numpy(k.copy()),
                                                              "v": torch.from_numpy(v.copy())},
                              torch.from_numpy(cur), quant=QuantPolicy.bf16(), positions3=torch.from_numpy(pos3))
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), **TOL)


def test_gelu_mlp_matches():
    jp = jlayers.gelu_mlp_init(jax.random.PRNGKey(3), 32, 128)
    tree = {k: (np.asarray(v) + _rand(v.shape, i) * (0.5 if k.endswith("_b") else 0)).astype(np.float32)
            for i, (k, v) in enumerate(sorted(jax.tree_util.tree_map(np.asarray, jp).items()))}
    tp = params_from_numpy(tree, device="cpu")
    x = _rand((2, 5, 32), 12) * 2
    want = jlayers.gelu_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in tree.items()}, JaxPolicy.bf16())
    got = tlayers.gelu_mlp(torch.from_numpy(x), tp, QuantPolicy.bf16())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = configs("whisper_base")
    jparams, _, tparams = trees(jcfg)
    return jcfg, tcfg, jparams, tparams


def test_encode_matches(whisper):
    jcfg, tcfg, jparams, tparams = whisper
    frames = _rand((1, jcfg.enc_frames, jcfg.d_model), 13)
    want = jtf.encode(jparams, jnp.asarray(frames), jcfg)
    got = ttf.encode(tparams, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cross_forward_matches(whisper):
    """Decoder queries against encoder frames, no causal mask, 1 and 5
    queries (a decode step and a prefill)."""
    jcfg, tcfg, jparams, tparams = whisper
    enc = _rand((1, jcfg.enc_frames, jcfg.d_model), 14)
    for sd in (1, 5):
        x = _rand((1, sd, jcfg.d_model), 15 + sd)
        want = jattn.cross_forward(jnp.asarray(x), jnp.asarray(enc), jax.tree_util.tree_map(
            lambda a: a[0], jparams["layers_0"]["xattn"]), jcfg)
        got = tattn.cross_forward(torch.from_numpy(x), torch.from_numpy(enc), tparams["layers_0"][0]["xattn"], tcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)

