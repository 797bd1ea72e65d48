"""The port's ``Engine.generate`` against the JAX package's, float32 compute.

Reduced ``llama3_2_3b`` (3 layers, d_model 64, 4 heads of 16) with the JAX
package's weights carried over by ``bridge``, served under the packed W4 +
RaZeR KV policy (KVH = H = 4) and the W4A4 + KV policy with KVH = 2, so that
GQA groups of G = 2 query heads are tested.  In float32 both packages do the
same arithmetic up to summation order, so the tolerances are tight.
"""
import numpy as np
import pytest

from _torch_engine_cases import check_greedy, kv_mismatch_fraction, run_case

LOGIT_TOL = 1e-5  # f32 sums in another order; observed <= 3e-7 on logits of magnitude ~0.6
KV_FRACTION = 1e-3  # packed KV bytes that may differ after prefill; observed 0


@pytest.fixture(scope="module", params=[("w4_kv", 4), ("w4a4_kv", 2)], ids=["w4_kv-G1", "w4a4_kv-G2"])
def case(request):
    policy, kv_heads = request.param
    return run_case(policy, kv_heads, "float32")


def test_prefill_last_logits_match(case):
    np.testing.assert_allclose(case["port_logits"][0], case["jax_logits"][0], rtol=0, atol=LOGIT_TOL)


def test_decode_step_logits_match(case):
    for step, (got, want) in enumerate(zip(case["port_logits"][1:], case["jax_logits"][1:])):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL, err_msg=f"decode step {step}")


def test_kv_cache_bytes_after_prefill_match(case):
    assert kv_mismatch_fraction(case, first_layer_only=True) == 0.0
    assert kv_mismatch_fraction(case) <= KV_FRACTION


def test_generate_greedy_tokens_match(case):
    check_greedy(case, LOGIT_TOL)
    assert case["port_tokens"] == case["jax_tokens"]  # no margin here is below LOGIT_TOL
