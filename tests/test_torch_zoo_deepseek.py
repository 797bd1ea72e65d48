"""Reduced ``deepseek_v2_236b`` in the port against the JAX package: MLA (the
materialized prefill through the prefill attention at head width nope + rope
with V at v_head_dim, the absorbed decode over the latent cache), MoE with a
shared expert after a dense first layer, a ragged batch through
``generate``'s bucketed prefill, under BF16, packed W4 + KV and W4A4 + KV,
in float32 (``_torch_zoo_cases``). Logits within the f32 tolerance, greedy
tokens equal, and MLA's latent caches -- which the KV policy leaves
unquantized, as the reference does -- within the f32 summation order of the
reference's. The walk tests of ``_torch_zoo_walk_cases`` (refusals, bridge,
packed paths and audit) run here on this arch, sharing the file's JAX
compiles."""
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
    return run_case("deepseek_v2_236b", request.param)


@pytest.fixture(scope="module")
def zoo():
    return walk_case("deepseek_v2_236b")


def test_mla_latent_caches_match(case):
    """Each layer's cache is the latent ``{"c", "kr"}`` (bf16 under the KV
    policy too: only GQA caches are packed), equal to the reference's
    within 1e-5 (float32 matmuls in another summation order)."""
    jl, tl = case["caches"]
    cfg = case["cfg"]
    for li, (want, got) in enumerate(zip(jl, tl)):
        assert set(got) == set(want) == {"c", "kr"}, li
        assert got["c"].shape[-1] == cfg.kv_lora_rank and got["kr"].shape[-1] == cfg.qk_rope_dim
        for name in ("c", "kr"):
            np.testing.assert_allclose(got[name], want[name].astype(np.float32), rtol=0, atol=1e-5,
                                       err_msg=f"layer {li} {name}")
