"""Reduced ``mamba2_370m`` in the port against the JAX package: three
Mamba-2 blocks (the in/out projections, the causal conv, the chunked SSD at
11 tokens, which its chunk of 8 does not divide, and the one-token
recurrent decode), through ``generate``'s exact-length prefill under BF16,
packed W4 + KV and W4A4 + KV, in float32 (``_torch_zoo_cases``).  Logits
within the f32 tolerance, greedy tokens equal, the SSD and conv states
within it (``_torch_recurrent_cases``); the walk tests (pool and serving
refusals, the paged paths, the packed paths and audit) share the file's
JAX compiles; a pure SSM has no max_len cap."""
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
    return run_case("mamba2_370m", request.param)


@pytest.fixture(scope="module")
def zoo():
    return walk_case("mamba2_370m")


def test_generate_max_len_cap_skips_pure_ssm(zoo):
    """A recurrent state has no (max_len,) cache: the overflow check does
    not apply to a pure SSM (as the reference's ``_check_prompts``), and
    the empty-prompt check still does."""
    _, _, _, _, eng = zoo
    out = eng.generate([list(range(1, 31))], max_new_tokens=8)  # 30 + 8 > max_len 32
    assert len(out[0]) == 38
    with pytest.raises(ValueError, match="empty"):
        eng.generate([[]])


def test_layers_have_no_mlp(zoo):
    _, _, tcfg, _, eng = zoo
    layers = eng._raw_params["layers_0"]
    assert len(layers) == tcfg.num_layers and all(set(lp) == {"ln1", "mixer"} for lp in layers)
