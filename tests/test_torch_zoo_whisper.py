"""Reduced ``whisper_base`` in the port against the JAX package: the encoder
(sinusoid positions, attention without rope or a causal mask, GELU MLPs with
biases, ``enc_layers`` carried by the bridge), the decoder's cross-attention
to the encoder output, read again at every decode step, one prompt through
``generate``'s exact-length prefill, under BF16, packed W4 + KV and W4A4 +
KV, in float32 (``_torch_zoo_cases``). Logits within the f32 tolerance,
greedy tokens equal, the packed KV bytes identical; a batch of two raises
where the reference fails. The walk tests of ``_torch_zoo_walk_cases``
(refusals, bridge, packed paths and audit) run here on this arch, sharing
the file's JAX compiles."""
import numpy as np
import pytest

from _torch_zoo_cases import (engines, extras, run_case, test_decode_step_logits_match,  # noqa: F401
                              test_generate_tokens_match, test_prefill_last_logits_match)
from _torch_zoo_walk_cases import (test_bridge_unstacks_the_encoder,  # noqa: F401
                                   test_packed_paths_and_audit_equal_the_reference,
                                   test_paged_paths_refuse_as_the_reference,
                                   test_pool_refuses_with_the_reference_words,
                                   test_serving_paths_raise_the_pool_refusal, walk_case)


@pytest.fixture(scope="module", params=["bf16", "w4_kv", "w4a4_kv"])
def case(request):
    return run_case("whisper_base", request.param)


@pytest.fixture(scope="module")
def zoo():
    return walk_case("whisper_base")


def test_kv_caches_match(case):
    jl, tl = case["caches"]
    for li, (want, got) in enumerate(zip(jl, tl)):
        assert set(got) == set(want), li
        for name in want:
            if want[name].dtype == np.uint8:
                np.testing.assert_array_equal(got[name], want[name], err_msg=f"layer {li} {name}")
            else:
                np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-5, err_msg=f"layer {li} {name}")


def test_batch_of_two_raises_where_the_reference_fails():
    """The reference's decode-step position embedding divides the batch's
    position vector by the frequencies and fails on two sequences
    (ROADMAP caveat 8); the port raises a ValueError naming the cause, after
    the same prefill, and generates one prompt."""
    je, te = engines("whisper_base", "bf16")
    jx, tx = extras(te.cfg, 2)
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(TypeError):
        je.generate(prompts, extras=jx, max_new_tokens=3)
    with pytest.raises(ValueError, match="one sequence"):
        te.generate(prompts, extras=tx, max_new_tokens=3)
    one = {"enc_frames": tx["enc_frames"][:1]}
    out = te.generate(prompts[:1], extras=one, max_new_tokens=3)
    assert len(out[0]) == 6 and all(0 <= t < te.cfg.vocab_size for t in out[0])
