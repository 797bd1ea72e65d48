"""The port's special-value calibration (§4.2, Fig. 3, App. B.2) and AWQ
(Table 8) against the JAX package on the CPU, seeded numpy inputs: the
Fig. 3 sweep within 1e-5 relative (both sum float32 squared errors, in
another order), the chosen weight pairs and activation pair equal, AWQ's
alpha equal and its output MSE within 1e-5 relative, and ``apply_awq``
bit-equal given the same scales."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import awq as jawq
from repro.core import calibration as jcal
from repro.core.baselines import int4_quantize as jint4
from repro.core.nvfp4 import nvfp4_qdq as jnvfp4_qdq
from repro.core.razer import razer_qdq as jrazer_qdq
from repro_torch.core import awq as tawq
from repro_torch.core import calibration as tcal
from repro_torch.core.baselines import int4_quantize as tint4
from repro_torch.core.nvfp4 import nvfp4_qdq as tnvfp4_qdq
from repro_torch.core.razer import razer_qdq as trazer_qdq

torch.set_num_threads(2)

SWEEP_RTOL = 1e-5


def _weights(shape=(512, 256), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_t(5, size=shape) * 0.02).astype(np.float32)


def test_default_magnitudes_equal():
    assert tcal.DEFAULT_SV_MAGNITUDES == jcal.DEFAULT_SV_MAGNITUDES


@pytest.mark.parametrize("base_pairs", [(), (5.0,)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sv_pair_sweep_within_float32_sum_order(seed, base_pairs):
    w = _weights(seed=seed)
    mags = [m for m in jcal.DEFAULT_SV_MAGNITUDES if m not in base_pairs]
    for kw in ({}, {"scale_fmt": "e4m3", "block_size": 32}):
        want = jcal.sv_pair_sweep(jnp.asarray(w), mags, base_pairs=base_pairs, **kw)
        got = tcal.sv_pair_sweep(torch.from_numpy(w), mags, base_pairs=base_pairs, **kw)
        assert list(got) == list(want)
        for m in want:
            assert abs(got[m] - want[m]) <= SWEEP_RTOL * abs(want[m]), (m, got[m], want[m])


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_selected_weight_pairs_equal(seed):
    w = _weights((256, 128), seed=seed)
    assert tcal.select_weight_sv_pairs(torch.from_numpy(w)) == jcal.select_weight_sv_pairs(jnp.asarray(w))


def test_activation_pair_equal():
    rng = np.random.default_rng(1)
    acts = [rng.standard_normal((64, 64)).astype(np.float32) * s for s in (1.0, 3.0, 0.2)]
    acts[1][:, ::7] *= 20  # outlier channels
    want = jcal.calibrate_activation_sv([jnp.asarray(a) for a in acts])
    assert tcal.calibrate_activation_sv([torch.from_numpy(a) for a in acts]) == want
    narrow = (4.5, 5.0, 5.5)
    assert tcal.calibrate_activation_sv([torch.from_numpy(a) for a in acts], narrow) == \
        jcal.calibrate_activation_sv([jnp.asarray(a) for a in acts], narrow)


QUANTIZE_FNS = {
    "razer": (lambda v: jrazer_qdq(v, axis=0), lambda v: trazer_qdq(v, axis=0)),
    "nvfp4": (lambda v: jnvfp4_qdq(v, axis=0), lambda v: tnvfp4_qdq(v, axis=0)),
    "int4": (lambda v: jint4(v, axis=0).dequantize(), lambda v: tint4(v, axis=0).dequantize()),
}


@pytest.mark.parametrize("fmt", list(QUANTIZE_FNS))
def test_awq_alpha_equal(fmt):
    jfn, tfn = QUANTIZE_FNS[fmt]
    w = _weights((256, 128), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    x[:, ::37] *= 25  # salient channels
    want = jawq.awq_search(jnp.asarray(w), x, jfn)
    got = tawq.awq_search(torch.from_numpy(w), x, tfn)
    assert got.alpha == want.alpha
    assert abs(got.out_mse - want.out_mse) <= 1e-5 * want.out_mse, (got.out_mse, want.out_mse)
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales), rtol=1e-5)
    # the same scales give the same weight, bit for bit
    same = tawq.AWQResult(scales=torch.from_numpy(np.array(want.scales)), alpha=want.alpha, out_mse=want.out_mse)
    w_j = np.asarray(jawq.apply_awq(jnp.asarray(w), want, jfn))
    w_t = tawq.apply_awq(torch.from_numpy(w), same, tfn).numpy()
    assert np.array_equal(w_j.view(np.int32), w_t.view(np.int32))
    # alpha 0 is on the grid, so AWQ never does worse than the plain quantizer
    ref = torch.from_numpy(x) @ torch.from_numpy(w)
    plain = float(((torch.from_numpy(x) @ tfn(torch.from_numpy(w)) - ref) ** 2).mean())
    assert got.out_mse <= plain
