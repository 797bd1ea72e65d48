"""The port's ``Engine.generate`` against the JAX package's, bf16 compute.

Same reduced ``llama3_2_3b`` and weights as ``test_torch_engine.py``, with
the policies on the other head layouts (W4 + KV with KVH = 2, W4A4 + KV with
KVH = 4).  In bf16 the packages round some intermediates differently (XLA's
logistic in SiLU, and its fusions that skip bf16 roundings, against
PyTorch's), and a one-ulp difference that lands on an FP4 or E4M3 rounding
boundary moves a value by a whole quantization step in the next layer.  The
first layer, which is reached before any such difference, is byte-exact;
the tolerances below cover the spread that follows, measured on these
inputs, with a margin of about two.
"""
import numpy as np
import pytest

from _torch_engine_cases import check_greedy, kv_mismatch_fraction, run_case

# per policy: (logit tolerance, fraction of KV bytes that may differ)
# observed: w4_kv 0.025 and 2.7 %, w4a4_kv 0.114 and 18 % (logits of magnitude ~0.55)
TOLERANCES = {"w4_kv": (0.06, 0.08), "w4a4_kv": (0.25, 0.35)}


@pytest.fixture(scope="module", params=[("w4_kv", 2), ("w4a4_kv", 4)], ids=["w4_kv-G2", "w4a4_kv-G1"])
def case(request):
    policy, kv_heads = request.param
    out = run_case(policy, kv_heads, "bfloat16")
    out["tol"], out["kv_fraction"] = TOLERANCES[policy]
    return out


def test_prefill_last_logits_match(case):
    np.testing.assert_allclose(case["port_logits"][0], case["jax_logits"][0], rtol=0, atol=case["tol"])


def test_decode_step_logits_match(case):
    for step, (got, want) in enumerate(zip(case["port_logits"][1:], case["jax_logits"][1:])):
        np.testing.assert_allclose(got, want, rtol=0, atol=case["tol"], err_msg=f"decode step {step}")


def test_kv_cache_bytes_after_prefill_match(case):
    assert kv_mismatch_fraction(case, first_layer_only=True) == 0.0
    assert kv_mismatch_fraction(case) <= case["kv_fraction"]


def test_generate_greedy_tokens_match_above_margin(case):
    check_greedy(case, case["tol"])
