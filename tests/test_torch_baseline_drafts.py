"""Self-speculative ``Engine.serve`` with a baseline-format draft (a
fakequant mxfp4, int4, nf4 or fouroversix copy of the same checkpoint)
against the JAX package's, float32 compute, packed W4 + RaZeR KV target on
the reduced llama: identical greedy tokens and counters, accepted drafts
(so the accept rate) included.  The port registered only nvfp4 and razer
before, so these drafts raised."""
import pytest

from _torch_serve_cases import assert_same_report, prompts, serve_both


@pytest.mark.parametrize("draft", ["mxfp4", "int4", "nf4", "fouroversix"])
def test_baseline_draft_serve_matches_jax(draft):
    specs = [(p, 8, 0.0, -1) for p in prompts((5, 11, 17, 3), seed=1)]
    jrep, trep = serve_both(specs, speculate_k=2, draft_policy=draft)
    assert_same_report(jrep, trep)
    assert trep.accept_rate == jrep.accept_rate and trep.drafted_tokens > 0
