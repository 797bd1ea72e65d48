"""The paper's dense models in the port against the JAX package, float32,
reduced, biases and norm gains drawn nonzero (``_torch_paper_cases``):
Llama-3.1-8B and Llama-2-7B (MHA) under W4 + KV, Qwen3-8B (qk-norm) under
W4 + KV and W4A4 + KV.  Logits within the engine tests' tolerance, the
packed KV bytes of every layer identical, greedy tokens equal.  No case here
has an activation block on an E4M3 boundary (ROADMAP C.2): every KV byte
agrees under W4A4 too.
"""
import pytest

from _torch_paper_cases import (build, test_decode_step_logits_match, test_generate_greedy_tokens_match,  # noqa: F401
                                test_kv_cache_bytes_match_in_every_layer, test_prefill_last_logits_match)

IDS = ["llama3_1_8b-w4_kv", "llama2_7b-mha-w4_kv", "qwen3_8b-qknorm-w4_kv", "qwen3_8b-qknorm-w4a4_kv"]


@pytest.fixture(scope="module", params=IDS)
def case(request):
    return build(request.param)
