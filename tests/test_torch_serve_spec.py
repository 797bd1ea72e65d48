"""The port's self-speculative ``Engine.serve(speculate_k=k)`` against the
JAX package's, float32 compute, packed W4 + RaZeR KV target: identical
greedy tokens and identical counters (decode iterations, drafted and
accepted tokens) for k in {1, 2} with the nvfp4, bf16 and same-policy
drafts, with prefix sharing and under slot pressure.  Mirrors
``tests/test_speculative.py``."""
import pytest

from _torch_serve_cases import assert_same_report, engines, prompts, requests, serve_both


def _specs(ps, n_new=8, arrival=0.0):
    return [(p, n_new, arrival * i, -1) for i, p in enumerate(ps)]


@pytest.mark.parametrize("draft", ["nvfp4", "bf16", "same"])
@pytest.mark.parametrize("k", [1, 2])
def test_speculative_serve_matches_jax(k, draft):
    specs = _specs(prompts((5, 11, 17, 3), seed=1))
    if draft == "same":  # each engine drafts with its own target policy
        je, te = engines()
        jrep = je.serve(requests(specs, False), speculate_k=k, draft_policy=je.scfg.quant)
        trep = te.serve(requests(specs, True), speculate_k=k, draft_policy=te.scfg.quant)
        assert trep.accept_rate == 1.0
    else:
        jrep, trep = serve_both(specs, speculate_k=k, draft_policy=draft)
    assert_same_report(jrep, trep)
    assert trep.speculate_k == k and trep.drafted_tokens > 0


def test_speculative_with_prefix_cache_and_dedup_matches_jax():
    base = prompts((16,), seed=4)[0]
    trace = [base, base[:12] + prompts((3,), seed=5)[0], list(base), base[:8]]
    jrep, trep = serve_both(_specs(trace), ps=4, speculate_k=2, draft_policy="nvfp4")
    assert_same_report(jrep, trep)
    assert trep.cached_tokens > 0


def test_speculative_under_slot_pressure_matches_jax_on_fake_clock():
    """More requests than slots and staggered arrivals: retirement and
    admission interleave with speculative growth and rollback."""
    specs = [(p, 4 + i % 3, 0.002 * i, -1) for i, p in enumerate(prompts([4 + i for i in range(6)], seed=5))]
    jrep, trep = serve_both(specs, slots=2, speculate_k=2, draft_policy="bf16", tick=0.001)
    assert_same_report(jrep, trep, clocked=True)
