"""The port's App. D.3 two-pass realization against the JAX package on the
CPU: ``split_special_value`` over the §D.3 reachable set, and the W_main /
W_comp halves bit-equal for several SV sets and both blocking axes; the
two passes equal the single pass within the reference test's rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import razer as jrazer
from repro.core import twopass as jtwo
from repro_torch.core import razer as trazer
from repro_torch.core import twopass as ttwo

torch.set_num_threads(2)

D3_SET = [s * m for m in (2.5, 3.5, 4.5, 5.0, 5.5, 6.5, 7.0, 7.5, 8.0, 9.0, 10.0, 12.0) for s in (1, -1)]


def test_split_special_value_over_the_d3_set():
    for v in D3_SET:
        assert ttwo.split_special_value(v) == jtwo.split_special_value(v), v
    for bad in (9.5, 13.0, 0.25):  # no sum of two FP4 values
        with pytest.raises(ValueError):
            jtwo.split_special_value(bad)
        with pytest.raises(ValueError):
            ttwo.split_special_value(bad)


@pytest.mark.parametrize("svs", [(5.0, -5.0, 8.0, -8.0), (5.0, -5.0, 7.0, -7.0), (2.5, -2.5, 9.0, -9.0)])
@pytest.mark.parametrize("axis", [0, -1])
def test_two_pass_halves_bit_equal(svs, axis):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    jbq = jrazer.razer_quantize(jnp.asarray(w), axis=axis, special_values=svs)
    tbq = trazer.razer_quantize(torch.from_numpy(w), axis=axis, special_values=svs)
    for j, t in zip(jtwo.two_pass_weights(jbq), ttwo.two_pass_weights(tbq)):
        assert np.array_equal(np.asarray(j).view(np.int32), t.numpy().view(np.int32))
    w_main, w_comp = ttwo.two_pass_weights(tbq)
    assert torch.equal(w_main + w_comp, tbq.dequantize())


def test_two_pass_matmul_equals_single_pass():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    y_t, density_t = ttwo.two_pass_matmul(torch.from_numpy(x), torch.from_numpy(w))
    y_j, density_j = jtwo.two_pass_matmul(jnp.asarray(x), jnp.asarray(w))
    assert float(density_t) == float(density_j) and 0 < float(density_t) < 0.2
    y1 = torch.from_numpy(x) @ trazer.razer_quantize(torch.from_numpy(w), axis=0).dequantize()
    np.testing.assert_allclose(y_t.numpy(), y1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
