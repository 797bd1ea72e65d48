"""Shared cases of the paper-model tests: reduced configs of the six dense
models the port added for the paper's evaluation, each served by the JAX
``Engine`` and by the port's from the same weights, with every qkv bias and
norm gain drawn nonzero from a seed (``_torch_engine_cases.perturb``), in
float32.

``CASES`` maps a case id to (policy, arch, config overrides); the G 7 case
gives reduced ``deepseek_coder_33b`` 7 query heads over 1 KV head (hd 16),
since ``reduced()`` caps the heads at 4.  Each is compared as the engine
tests compare llama3_2_3b (the ``test_*`` functions below, which the test
files import): logits within ``LOGIT_TOL``, the packed KV bytes of every
layer identical, greedy tokens equal.
"""
import numpy as np

from _torch_engine_cases import check_greedy, kv_mismatch_fraction, run_case

LOGIT_TOL = 1e-5  # the engine tests' f32 tolerance (tests/test_torch_engine.py)
PERTURB_SEED = 1

CASES = {
    "llama3_1_8b-w4_kv": ("w4_kv", "llama3_1_8b", {}),
    "llama2_7b-mha-w4_kv": ("w4_kv", "llama2_7b", {}),
    "qwen3_8b-qknorm-w4_kv": ("w4_kv", "qwen3_8b", {}),
    "qwen3_8b-qknorm-w4a4_kv": ("w4a4_kv", "qwen3_8b", {}),
    "codeqwen1_5_7b-bias-mha-w4_kv": ("w4_kv", "codeqwen1_5_7b", {}),
    "deepseek_coder_33b-G7-w4_kv": ("w4_kv", "deepseek_coder_33b",
                                    dict(num_heads=7, num_kv_heads=1, d_model=7 * 16, d_ff=4 * 7 * 16)),
}


def build(case_id: str):
    policy, arch, overrides = CASES[case_id]
    return run_case(policy, None, "float32", arch=arch, perturb_seed=PERTURB_SEED, **overrides)


# the comparisons, imported by each test file beside its own ``case`` fixture
def test_prefill_last_logits_match(case):
    np.testing.assert_allclose(case["port_logits"][0], case["jax_logits"][0], rtol=0, atol=LOGIT_TOL)


def test_decode_step_logits_match(case):
    for step, (got, want) in enumerate(zip(case["port_logits"][1:], case["jax_logits"][1:])):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL, err_msg=f"decode step {step}")


def test_kv_cache_bytes_match_in_every_layer(case):
    assert kv_mismatch_fraction(case) == 0.0


def test_generate_greedy_tokens_match(case):
    check_greedy(case, LOGIT_TOL)
    assert case["port_tokens"] == case["jax_tokens"]
