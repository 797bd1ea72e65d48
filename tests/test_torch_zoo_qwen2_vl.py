"""Reduced ``qwen2_vl_7b`` in the port against the JAX package: M-RoPE, qkv
biases, and the vision stub's patch embeddings written over the leading
positions of a ragged batch, through ``generate``'s exact-length prefill
(which attends the in-pass K/V, as the reference's does) and decode over the
packed cache, under BF16, packed W4 + KV and W4A4 + KV, in float32
(``_torch_zoo_cases``). Logits within the f32 tolerance, greedy tokens
equal, the packed KV bytes of every layer identical. The walk tests of
``_torch_zoo_walk_cases`` (refusals, bridge, packed paths and audit) run
here on this arch, sharing the file's JAX compiles."""
import numpy as np
import pytest

from _torch_zoo_cases import (run_case, test_decode_step_logits_match,  # noqa: F401
                              test_generate_tokens_match, test_prefill_last_logits_match)
from _torch_zoo_walk_cases import (test_bridge_unstacks_the_encoder,  # noqa: F401
                                   test_packed_paths_and_audit_equal_the_reference,
                                   test_paged_paths_refuse_as_the_reference,
                                   test_pool_refuses_with_the_reference_words,
                                   test_serving_paths_raise_the_pool_refusal, walk_case)


@pytest.fixture(scope="module", params=["bf16", "w4_kv", "w4a4_kv"])
def case(request):
    return run_case("qwen2_vl_7b", request.param)


@pytest.fixture(scope="module")
def zoo():
    return walk_case("qwen2_vl_7b")


def test_kv_caches_match(case):
    """Packed policies: every layer's wire bytes identical; BF16: the bf16
    caches within the f32 tolerance."""
    jl, tl = case["caches"]
    for li, (want, got) in enumerate(zip(jl, tl)):
        assert set(got) == set(want), li
        for name in want:
            if want[name].dtype == np.uint8:
                np.testing.assert_array_equal(got[name], want[name], err_msg=f"layer {li} {name}")
            else:
                np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=f"layer {li} {name}")


def test_patch_embeddings_change_the_output(case):
    """The frontend's embeddings reach the model: generate without them
    gives other tokens."""
    assert case["port_tokens_plain"] != case["port_tokens"]
