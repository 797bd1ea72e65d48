"""The PyTorch port's numerics and wire formats against the JAX package.

Same numpy inputs go through ``repro`` (JAX, CPU) and ``repro_torch`` (CPU
tensors); wire bytes must be byte-identical and dequantized values equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import formats as jformats
from repro.core.packing import pack_weight as jax_pack_weight
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.models import transformer as jax_tf
from repro.serving.engine import pack_model_weights as jax_pack_model_weights
from repro.serving.kvcache import kv_dequantize as jax_kv_dequantize
from repro.serving.kvcache import kv_quantize as jax_kv_quantize
from repro.serving.kvcache import quantized_gqa_cache_init as jax_cache_init
from repro_torch.bridge import packed_from_numpy, params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core import formats
from repro_torch.core.packing import pack_weight
from repro_torch.core.policy import QuantPolicy
from repro_torch.serving.engine import pack_model_weights
from repro_torch.serving.kvcache import kv_dequantize, kv_quantize, quantized_gqa_cache_init

torch.set_num_threads(2)

SV_SETS = [(5.0, 8.0), (5.0, 7.0), (5.0, 9.0), (5.0, 5.0), (7.0, 9.0)]


def _fp4_midpoint_block(rng, svs):
    """A block of absmax 6 (scale 1 when the tensor scale is 1) whose other
    elements sit exactly on midpoints of FP4 and of FP4 with each SV."""
    mids = set(formats.grid_midpoints(np.unique(formats.FP4_VALUES)).tolist())
    for v in svs:
        grid = np.unique(np.concatenate([np.unique(formats.FP4_VALUES), [np.float32(v)]]))
        mids |= set(formats.grid_midpoints(grid).tolist())
    pool = np.array(sorted(m for m in mids if abs(m) <= 6.0), np.float32)
    blk = rng.choice(pool, 16)
    blk[rng.integers(16)] = 6.0 * rng.choice([-1.0, 1.0])
    return blk.astype(np.float32)


def _adversarial_blocks(rng, n_blocks, scale_fmt, svs):
    """(n_blocks, 16) float32 rows, cycling through block kinds that stress
    the tie rules: FP4/SV midpoints, block scales on the scale grid's
    midpoints, all-zero blocks, blocks whose scale rounds to 0, and random."""
    smids = formats.grid_midpoints(formats.positive_format_values(scale_fmt))
    out = []
    for i in range(n_blocks):
        kind = i % 5
        if kind == 0:
            blk = _fp4_midpoint_block(rng, svs)
        elif kind == 1:  # absmax / 6 exactly on a scale-grid midpoint
            blk = rng.uniform(-1, 1, 16).astype(np.float32)
            blk[0] = 1.0
            blk = blk * np.float32(6.0 * rng.choice(smids))
        elif kind == 2:
            blk = np.zeros(16, np.float32)
        elif kind == 3:  # tiny: the block scale rounds to 0 and is promoted
            blk = rng.standard_normal(16).astype(np.float32) * np.float32(1e-4)
        else:
            blk = rng.standard_normal(16).astype(np.float32) * np.float32(rng.uniform(0.1, 4))
        out.append(blk.astype(np.float32))
    return np.stack(out)


def _weight(rng, k, n, svs, adversarial):
    """(K, N) weight; its global absmax is 180 so the tensor scale is 1 and
    the adversarial blocks keep their exact values after scaling."""
    if adversarial:
        blocks = _adversarial_blocks(rng, n * (k // 16), "e3m3", svs)  # (N*K/16, 16)
        w = blocks.reshape(n, k).T.copy()
    else:
        w = rng.standard_normal((k, n)).astype(np.float32)
    w[0, 0] = 180.0
    return w


@pytest.mark.parametrize("svs", SV_SETS)
@pytest.mark.parametrize("adversarial", [False, True], ids=["random", "adversarial"])
def test_pack_weight_bytes_match_jax(svs, adversarial):
    """codes, scale_meta and tensor_scale are byte-identical (tolerance 0).
    The SSE comparisons see exact ties on the midpoint blocks; no block's
    choice differs from the JAX package (0 blocks counted), so the sum order
    does not show in these inputs."""
    rng = np.random.default_rng(2 * SV_SETS.index(svs) + adversarial)
    w = _weight(rng, 128, 48, svs, adversarial)
    ref = jax_pack_weight(jnp.asarray(w), sv_magnitudes=svs)
    got = pack_weight(torch.from_numpy(w), sv_magnitudes=svs)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scale_meta.numpy(), np.asarray(ref.scale_meta))
    assert got.tensor_scale.numpy().tobytes() == np.asarray(ref.tensor_scale).tobytes()
    assert got.shape == tuple(ref.shape) and got.sv_magnitudes == tuple(ref.sv_magnitudes)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_pack_weight_random_scales_match_jax(scale):
    """Tensor scales other than 1: the same bytes (tolerance 0)."""
    rng = np.random.default_rng(int(scale * 1000) % 997)
    w = (rng.standard_normal((256, 64)) * scale).astype(np.float32)
    ref = jax_pack_weight(jnp.asarray(w))
    got = pack_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scale_meta.numpy(), np.asarray(ref.scale_meta))
    assert got.tensor_scale.numpy().tobytes() == np.asarray(ref.tensor_scale).tobytes()


@pytest.mark.parametrize("svs", SV_SETS[:3])
def test_packed_dequantize_matches_jax(svs):
    """The JAX package's wire bytes, bridged, dequantize to the same f32
    weights (tolerance 0)."""
    rng = np.random.default_rng(7)
    w = _weight(rng, 64, 32, svs, adversarial=True)
    ref = jax_pack_weight(jnp.asarray(w), sv_magnitudes=svs)
    pw = packed_from_numpy(np.asarray(ref.codes), np.asarray(ref.scale_meta),
                           np.asarray(ref.tensor_scale), ref.sv_magnitudes, ref.shape, device="cpu")
    np.testing.assert_array_equal(pw.dequantize().numpy(), np.asarray(ref.dequantize()))


@pytest.mark.parametrize("adversarial", [False, True], ids=["random", "adversarial"])
def test_kv_quantize_bytes_match_jax(adversarial):
    """KV codes and meta bytes are byte-identical; the dequantized cache
    equal (tolerance 0)."""
    rng = np.random.default_rng(11 + adversarial)
    if adversarial:
        x = _adversarial_blocks(rng, 2 * 5 * 3 * 4, "e4m3", (5.0,)).reshape(2, 5, 3, 64)
    else:
        x = (rng.standard_normal((2, 5, 3, 64)) * 3).astype(np.float32)
    jc, jm = jax_kv_quantize(jnp.asarray(x))
    c, m = kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(kv_dequantize(c, m, 64).numpy(),
                                  np.asarray(jax_kv_dequantize(jc, jm, 64)))


def test_kv_quantize_bf16_input_matches_jax():
    """bf16 K/V (the engine's compute dtype) quantize to the same bytes."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 2, 32)) * 2).astype(np.float32)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jc, jm = jax_kv_quantize(jnp.asarray(xb).astype(jnp.bfloat16))
    c, m = kv_quantize(torch.from_numpy(xb).to(torch.bfloat16))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_quantized_cache_layout_matches_jax():
    cfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), num_kv_heads=2)
    tcfg = dataclasses.replace(torch_get_config("llama3_2_3b").reduced(), num_kv_heads=2)
    want = jax_cache_init(cfg, 3, 8)
    got = quantized_gqa_cache_init(tcfg, 3, 8, "cpu")
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert tuple(got[name].shape) == arr.shape and got[name].dtype == torch.uint8
        assert not got[name].any()


@pytest.mark.parametrize("fmt", ["e4m3", "e3m3", "fp4"])
def test_format_grids_match_jax(fmt):
    np.testing.assert_array_equal(formats.positive_format_values(fmt),
                                  jformats.positive_format_values(fmt))


def test_round_to_values_ties_go_down_like_jax():
    """Every midpoint of the E4M3 and signed FP4 grids, and its neighbours
    one ulp away, round as the JAX package rounds them (tolerance 0)."""
    for grid in (formats.positive_format_values("e4m3"), np.unique(formats.FP4_VALUES)):
        mids = formats.grid_midpoints(grid)
        x = np.concatenate([mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf)])
        got = formats.round_to_values(torch.from_numpy(x), grid).numpy()
        np.testing.assert_array_equal(got, np.asarray(jformats.round_to_values(jnp.asarray(x), grid)))
        assert (got[: len(mids)] == grid[:-1]).all()  # ties to the lower value


def test_fp4_encode_matches_jax_and_never_emits_code_8():
    x = np.concatenate([np.unique(formats.FP4_VALUES), [-0.0, 0.0, 0.25, -0.25, 7.0, -7.0]]).astype(np.float32)
    got = formats.fp4_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jformats.fp4_encode(jnp.asarray(x))))
    assert 8 not in got.tolist()


def test_pack_model_weights_matches_jax_per_layer():
    """The reduced model's tree packs layer by layer to the JAX package's
    bytes; the same leaves stay dense (rules resolve the same paths)."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), num_kv_heads=2)
    jp = jax_tf.init_params(jax.random.PRNGKey(1), cfg)
    jpk = jax_pack_model_weights(jp, cfg, JaxPolicy.packed())
    tcfg = dataclasses.replace(torch_get_config("llama3_2_3b").reduced(), num_kv_heads=2)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tpk = pack_model_weights(tp, tcfg, QuantPolicy.packed())
    assert isinstance(tpk["embed"], torch.Tensor) and isinstance(tpk["layers_0"][0]["ln1"], torch.Tensor)
    for li, layer in enumerate(tpk["layers_0"]):
        for grp, names in (("mixer", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                ref = jpk["layers_0"][grp][name]
                got = layer[grp][name]
                np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes[li]))
                np.testing.assert_array_equal(got.scale_meta.numpy(), np.asarray(ref.scale_meta[li]))
                assert got.tensor_scale.numpy().tobytes() == np.asarray(ref.tensor_scale[li]).tobytes()


def test_bridge_unstacks_layers_and_keeps_dtypes():
    cfg = get_config("llama3_2_3b").reduced()
    jp = jax.tree_util.tree_map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), cfg))
    tp = params_from_numpy(jp, device="cpu")
    assert isinstance(tp["layers_0"], list) and len(tp["layers_0"]) == cfg.num_layers
    np.testing.assert_array_equal(tp["layers_0"][2]["mixer"]["wk"].numpy(), jp["layers_0"]["mixer"]["wk"][2])
    assert tp["embed"].dtype == torch.float32
    pw = packed_from_numpy(np.zeros((8, 4), np.uint8), np.zeros((1, 4), np.uint8), np.float32(1.0),
                           (5.0, 8.0), (16, 4), device="cpu")
    assert pw.codes.dtype == torch.uint8 and pw.tensor_scale.dtype == torch.float32
