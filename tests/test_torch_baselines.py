"""The port's §5.1 baseline formats, registry entries, fp16 scale/meta words,
offset registers and small numerics helpers against the JAX package on the
CPU.  Quantizer outputs (``q``, ``block_scale``, ``tensor_scale``) and wire
words must be bit-equal: the inputs are seeded numpy, including values one
ulp around powers of two (MXFP4's exponent), int4 rounding ties, NF4 absmax
above fp16's 65504, all-zero blocks and both blocking axes."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import baselines as jb
from repro.core import formats as jformats
from repro.core import nvfp4 as jnvfp4
from repro.core import packing as jpacking
from repro.core import policy as jpolicy
from repro.core import razer as jrazer
from repro.core import registry as jregistry
from repro_torch.core import baselines as tb
from repro_torch.core import formats as tformats
from repro_torch.core import nvfp4 as tnvfp4
from repro_torch.core import packing as tpacking
from repro_torch.core import policy as tpolicy
from repro_torch.core import razer as trazer
from repro_torch.core import registry as tregistry

# the packages export a function named qlinear beside the module
jqlinear = importlib.import_module("repro.core.qlinear")
tqlinear = importlib.import_module("repro_torch.core.qlinear")
torch.set_num_threads(2)

QUANTIZERS = ("mxfp4_quantize", "int4_quantize", "nf4_quantize", "fouroversix_quantize")


def _bits(a) -> np.ndarray:
    """An array's raw bytes, so that equality is bit equality (-0 != +0)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8).reshape(-1) if a.size else a.view(np.uint8)


def assert_bit_equal(j, t, what=""):
    j, t = np.asarray(j), t.detach().cpu().numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (what, j.shape, t.shape, j.dtype, t.dtype)
    assert np.array_equal(_bits(j), _bits(t)), (what, int((j != t).sum()), j.size)


def assert_same_quantized(jq, tq, what=""):
    for field in ("q", "block_scale", "tensor_scale"):
        assert_bit_equal(getattr(jq, field), getattr(tq, field), (what, field))
    assert jq.axis == tq.axis


def _near_powers_of_two(rng, k_lo=-100, k_hi=100, ulps=130):
    """Block maxima within ``ulps`` float32 ulps of 2^k, both sides, each
    at the head of a random row of smaller magnitudes (one block of 32)."""
    k = rng.integers(k_lo, k_hi, 512)
    bits = np.ldexp(np.float32(1), k).astype(np.float32).view(np.int32) + rng.integers(-ulps, ulps + 1, 512)
    peak = bits.astype(np.int32).view(np.float32)
    rows = rng.uniform(-1, 1, (512, 32)).astype(np.float32) * peak[:, None]
    rows[:, 0] = peak * rng.choice(np.float32([-1, 1]), 512)
    return rows


def _inputs(rng):
    """name -> float32 (rows, 64) inputs; every row and column count is a
    multiple of 64, so both axes block at 16, 32 and 64."""
    pow2 = _near_powers_of_two(rng).reshape(256, 64)
    ties = (rng.integers(-7, 8, (128, 64)) + 0.5 * rng.choice([0, 1], (128, 64))).astype(np.float32)
    ties[:, ::16] = 7.0  # absmax 7: int4 scale 1, every half-integer a tie
    big = rng.standard_normal((128, 64)).astype(np.float32) * np.float32(5e4)
    big[::2, 0] = np.float32(7e4)  # absmax above fp16's 65504
    zeros = rng.standard_normal((128, 64)).astype(np.float32)
    zeros[:64] = 0.0
    zeros[:, :16] = 0.0
    return {"pow2": pow2, "ties": ties, "big": big, "zeros": zeros,
            "normal": (rng.standard_t(5, (256, 128)) * 0.02).astype(np.float32)}


@pytest.mark.parametrize("name", QUANTIZERS)
def test_baseline_quantizers_bit_equal(name):
    rng = np.random.default_rng(0)
    jfn, tfn = getattr(jb, name), getattr(tb, name)
    for kind, x in _inputs(rng).items():
        for axis in (-1, 0):
            for bs in (16, 32, 64):
                jq = jfn(jnp.asarray(x), block_size=bs, axis=axis)
                tq = tfn(torch.from_numpy(x), block_size=bs, axis=axis)
                assert_same_quantized(jq, tq, (name, kind, axis, bs))
                assert_bit_equal(jq.dequantize(), tq.dequantize(), (name, kind, axis, bs, "dequantize"))


def test_fouroversix_scale_format_and_tensor_scale_bit_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 96)) * 3).astype(np.float32)
    for kw in ({"scale_fmt": "e3m3"}, {"scale_fmt": "e4m3", "tensor_scale": np.float32(0.0125)}):
        jkw = {k: (jnp.asarray(v) if k == "tensor_scale" else v) for k, v in kw.items()}
        tkw = {k: (torch.tensor(v) if k == "tensor_scale" else v) for k, v in kw.items()}
        assert_same_quantized(jb.fouroversix_quantize(jnp.asarray(x), **jkw),
                              tb.fouroversix_quantize(torch.from_numpy(x), **tkw), kw)


def test_log2_steps_are_the_references():
    """Every step of the reference's float32 floor(log2) (k = -124 .. 127)
    and ceil(log2) (k = 0 .. 127) within 2000 ulps of 2^k, and exp2 of every
    E8M0 exponent, equal the port's tables."""
    k = np.arange(-124, 128)
    offs = np.arange(-2000, 2001)
    bits = np.ldexp(np.float32(1), k).astype(np.float32).view(np.int32)[:, None] + offs[None, :]
    x = bits.astype(np.int32).view(np.float32)
    jlog = jnp.log2(jnp.asarray(x))
    assert_bit_equal(np.asarray(jnp.floor(jlog)).astype(np.int64), tformats.floor_log2(torch.from_numpy(x)))
    pos = k >= 0
    jceil = np.maximum(np.asarray(jnp.ceil(jlog[pos])), 0).astype(np.int64)
    assert_bit_equal(jceil, tformats.ceil_log2(torch.from_numpy(x[pos])))
    e = np.arange(-127, 128)
    assert_bit_equal(jnp.exp2(jnp.asarray(e.astype(np.float32))), tformats.exp2_int(torch.from_numpy(e)))


def test_registry_formats_and_block_sizes():
    assert tregistry.format_names() == jregistry.format_names()
    assert set(tregistry.format_names()) >= {"nvfp4", "razer", "mxfp4", "int4", "nf4", "fouroversix"}
    for name in jregistry.format_names():
        jspec = jpolicy.TensorSpec.weight(name, block_size=16)
        tspec = tpolicy.TensorSpec.weight(name, block_size=16)
        assert tspec.effective_block_size == jspec.effective_block_size
        assert tregistry.get_format(name).min_block_size == jregistry.get_format(name).min_block_size
        assert tregistry.spec_kwargs(tspec.entry, tspec) == jregistry.spec_kwargs(jspec.entry, jspec)
    assert tpolicy.TensorSpec.weight("mxfp4").effective_block_size == 32
    assert tpolicy.TensorSpec.weight("mxfp4", block_size=64).effective_block_size == 64


@pytest.mark.parametrize("name", ["mxfp4", "int4", "nf4", "fouroversix", "nvfp4"])
def test_spec_qdq_and_qdq_weight_bit_equal(name):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((128, 48)) * 0.05).astype(np.float32)
    jpol = jpolicy.QuantPolicy.fakequant(name)
    tpol = tpolicy.QuantPolicy.fakequant(name)
    assert_bit_equal(jqlinear.qdq_weight(jnp.asarray(w), jpol), tqlinear.qdq_weight(torch.from_numpy(w), tpol))
    cfg = dict(mode="fakequant", weight_format=name)
    assert_bit_equal(jqlinear.qdq_weight(jnp.asarray(w), jqlinear.QuantConfig(**cfg)),
                     tqlinear.qdq_weight(torch.from_numpy(w), tqlinear.QuantConfig(**cfg)))
    x = rng.standard_normal((5, 128)).astype(np.float32)
    y = tqlinear.qlinear(torch.from_numpy(x), tqlinear.QuantizedLinear.create(torch.from_numpy(w), tpol), tpol)
    np.testing.assert_allclose(y.numpy(), x @ np.asarray(jqlinear.qdq_weight(jnp.asarray(w), jpol)),
                               rtol=1e-5, atol=1e-6)  # an f32 matmul's summation order


def test_qdq_helpers_and_value_sets_bit_equal():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 32)) * 2).astype(np.float32)
    for axis in (0, -1):
        assert_bit_equal(jnvfp4.nvfp4_qdq(jnp.asarray(x), axis=axis), tnvfp4.nvfp4_qdq(torch.from_numpy(x), axis=axis))
        assert_bit_equal(jrazer.razer_qdq(jnp.asarray(x), axis=axis), trazer.razer_qdq(torch.from_numpy(x), axis=axis))
    for fmt in ("e4m3", "e3m3", "e2m1", "e5m2", "e3m2"):
        assert np.array_equal(jformats.float_format_values(fmt), tformats.float_format_values(fmt))
        for signed in (True, False):
            assert_bit_equal(jformats.round_to_format(jnp.asarray(x), fmt, signed),
                             tformats.round_to_format(torch.from_numpy(x), fmt, signed))
            jvs, tvs = jformats.ValueSet.from_format(fmt, signed), tformats.ValueSet.from_format(fmt, signed)
            assert jvs.values == tvs.values and jvs.max == tvs.max
            assert_bit_equal(jvs.round(jnp.asarray(x)), tvs.round(torch.from_numpy(x)))


def test_offset_registers_every_encodable_magnitude():
    mags = [6.0 + o / 2 for o in range(-7, 8)]
    for m in mags:
        code = tpacking.encode_offset_register(m)
        assert code == jpacking.encode_offset_register(m) and 0 <= code < 16
        assert tpacking.decode_offset_register(code) == jpacking.decode_offset_register(code) == m
    for code in range(16):
        assert tpacking.decode_offset_register(code) == jpacking.decode_offset_register(code)
    for bad in (2.0, 9.75, 10.0, 5.25):
        with pytest.raises(ValueError):
            tpacking.encode_offset_register(bad)


def test_fp16_scale_meta_words_bit_equal():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((256, 64)) * rng.uniform(0.01, 40, (1, 64))).astype(np.float32)
    bq = jrazer.razer_quantize(jnp.asarray(w), axis=0)
    jscales, jts = jpacking.fold_scales_below_two(bq.block_scale, bq.tensor_scale)
    tscales, tts = tpacking.fold_scales_below_two(torch.from_numpy(np.array(bq.block_scale)),
                                                  torch.from_numpy(np.array(bq.tensor_scale)))
    assert_bit_equal(jscales, tscales, "folded scales")
    assert_bit_equal(jts, tts, "folded tensor scale")
    assert float(tscales.max()) < 2.0
    sv_index = np.array(bq.sv_index)
    jw = jpacking.pack_scale_meta_fp16(jscales, jnp.asarray(sv_index))
    tw = tpacking.pack_scale_meta_fp16(tscales, torch.from_numpy(sv_index))
    assert tw.dtype == torch.uint16
    assert_bit_equal(jw, tw, "fp16 words")
    for mags in ((5.0, 8.0), (4.5, 9.5)):
        js, jsv = jpacking.unpack_scale_meta_fp16(jw, mags)
        ts, tsv = tpacking.unpack_scale_meta_fp16(tw, mags)
        assert_bit_equal(js, ts, "unpacked scale")
        assert_bit_equal(jsv, tsv, "unpacked sv")
    # scales at and above 2.0 (the bits the metadata takes are masked), and
    # a fold of scales spanning many binades
    big = np.float32([0.5, 1.999, 2.0, 3.5, 100.0, 60000.0])
    idx = np.int32([-1, 0, 1, 2, 3, 1])
    assert_bit_equal(jpacking.pack_scale_meta_fp16(jnp.asarray(big), jnp.asarray(idx)),
                     tpacking.pack_scale_meta_fp16(torch.from_numpy(big), torch.from_numpy(idx)))
    for top in (1.0, 2.0, 2.0000002, 3.0, 1e3, 7e37, 1e-3):
        s = (rng.uniform(0.01, 1, 64) * top).astype(np.float32)
        s[0] = top
        jr = jpacking.fold_scales_below_two(jnp.asarray(s), jnp.float32(1.5))
        tr = tpacking.fold_scales_below_two(torch.from_numpy(s), torch.tensor(1.5))
        assert_bit_equal(jr[0], tr[0], top)
        assert_bit_equal(jr[1], tr[1], top)


def test_core_exports_the_references_names():
    assert set(jcore.__all__) <= set(tcore.__all__), set(jcore.__all__) - set(tcore.__all__)
