"""Reduced ``recurrentgemma_2b`` in the port against the JAX package: the
RG-LRU blocks (the associative scan, the gates, the causal conv) and the
local-attention layers with their sliding window (the prefill attention
with a window, the windowed decode over the bf16 or packed cache), in the
pattern r, r, a, through ``generate``'s exact-length prefill under BF16,
packed W4 + KV and W4A4 + KV, in float32 (``_torch_zoo_cases``); prompts of
11 tokens outrun the window of 8.  Logits within the f32 tolerance, greedy
tokens equal, the recurrent states within it and the attention layer's KV
bytes equal (``_torch_recurrent_cases``); the walk tests (pool and serving
refusals, the paged paths, the packed paths and audit) share the file's
JAX compiles."""
import pytest

from _torch_recurrent_cases import (test_decode_states_match,  # noqa: F401
                                    test_generate_prefills_at_the_exact_length,
                                    test_packed_tree_bytes_equal_the_reference,
                                    test_short_prompts_fail_where_the_reference_fails,
                                    test_unequal_prompt_lengths_refused_as_the_reference)
from _torch_zoo_cases import (run_case, test_decode_step_logits_match,  # noqa: F401
                              test_generate_tokens_match, test_prefill_last_logits_match)
from _torch_zoo_walk_cases import (test_packed_paths_and_audit_equal_the_reference,  # noqa: F401
                                   test_paged_paths_refuse_as_the_reference,
                                   test_pool_refuses_with_the_reference_words,
                                   test_serving_paths_raise_the_pool_refusal, walk_case)


@pytest.fixture(scope="module", params=["bf16", "w4_kv", "w4a4_kv"])
def case(request):
    return run_case("recurrentgemma_2b", request.param)


@pytest.fixture(scope="module")
def zoo():
    return walk_case("recurrentgemma_2b")


def test_layer_pattern_and_window(zoo):
    from repro_torch.models.transformer import layer_groups

    _, _, tcfg, _, eng = zoo
    assert layer_groups(tcfg) == [("r", 2), ("a", 1)] and tcfg.window == 8
    assert set(eng._raw_params["layers_0"][0]["mixer"]) == {"w_in", "w_gate", "conv_w", "conv_b", "wa", "wx",
                                                            "a_param", "out_proj"}
