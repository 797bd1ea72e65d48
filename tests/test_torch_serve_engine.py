"""The port's ``Engine.serve`` against the JAX package's, float32 compute,
packed W4 + RaZeR KV: identical greedy tokens, identical ``ServeReport``
counters and, under a ``FakeClock``, identical TTFT and latency lists.

Cases mirror ``tests/test_paged_serving.py`` and ``tests/test_prefix_cache.py``:
mixed prompt lengths, page-boundary crossings at page size 4, slot reuse,
EOS and mixed ``max_new``, out-of-order arrivals, and prefix-cache hits at
aligned, mid-page (copy-on-write), super-prefix and page-boundary split
points.
"""
import pytest

from _torch_serve_cases import SHARED, assert_same_report, engines, prompts, serve_both


def _specs(ps, n_new=8, arrival=0.0, eos=-1):
    return [(p, n_new, arrival * i, eos) for i, p in enumerate(ps)]


@pytest.mark.parametrize("tick", [None, 0.001], ids=["wall-clock", "fake-clock"])
def test_serve_mixed_lengths_matches_jax(tick):
    jrep, trep = serve_both(_specs(prompts((5, 11, 17, 3))), tick=tick)
    assert_same_report(jrep, trep, clocked=tick is not None)
    assert all(r.state == "finished" for r in trep.requests)


def test_serve_page_boundary_crossings_match_jax():
    """Page size 4: decode crosses page boundaries and attends many pages."""
    jrep, trep = serve_both(_specs([list(range(1, 11)), [11, 12, 13]], n_new=10), ps=4, num_pages=16)
    assert_same_report(jrep, trep)


def test_serve_slot_reuse_matches_jax():
    """Five requests over two slots: slots are reused as requests retire."""
    jrep, trep = serve_both(_specs([[i + 1, i + 2, i + 3] for i in range(5)]), slots=2, tick=0.001)
    assert_same_report(jrep, trep, clocked=True)
    assert trep.peak_slots == 2


def test_serve_eos_and_mixed_max_new_match_jax():
    base = [([1, 2, 3], 6, 0.0, -1), ([4, 5, 6, 7], 2, 0.0, -1), ([8, 9], 7, 0.0, -1)]
    jrep, trep = serve_both(base)
    assert_same_report(jrep, trep)
    assert [len(r.out_tokens) for r in trep.requests] == [6, 2, 7]
    eos = trep.requests[0].out_tokens[2]
    jrep, trep = serve_both([([1, 2, 3], 6, 0.0, eos)] + base[1:])
    assert_same_report(jrep, trep)
    assert trep.requests[0].out_tokens[-1] == eos and len(trep.requests[0].out_tokens) <= 3


def test_serve_out_of_order_arrivals_match_jax_on_fake_clock():
    """Submitted out of arrival order: the later-submitted, earlier-arriving
    request is admitted first, and the FakeClock makes every latency exact."""
    specs = [([1, 2, 3], 3, 0.3, -1), ([4, 5, 6, 7], 3, 0.0, -1), ([9, 8, 7, 6, 5], 4, 0.05, -1)]
    jrep, trep = serve_both(specs, tick=0.001)
    assert_same_report(jrep, trep, clocked=True)
    assert trep.requests[1].first_token_time < trep.requests[0].first_token_time


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["cache-on", "cache-off"])
def test_serve_prefix_cache_split_points_match_jax(prefix_cache):
    """Aligned, partial-page (COW), longest-match, super-prefix and miss
    split points at page size 4."""
    ps = [SHARED + [11, 12, 13], SHARED + [14, 15], SHARED + [11, 12, 13, 14, 15],
          SHARED[:5] + [20, 21], list(SHARED), [40, 41, 42]]
    jrep, trep = serve_both(_specs(ps, n_new=6), ps=4, prefix_cache=prefix_cache)
    assert_same_report(jrep, trep)
    if prefix_cache:
        assert trep.cache_hits >= 4 and trep.cached_tokens > 0


def test_serve_prefix_cache_page_boundary_and_donor_gone_match_jax():
    """Split exactly at a page boundary, a page-aligned identical prompt
    (the clamp forces a COW of the last chunk), and a hit after the donor
    retired, on one slot with staggered arrivals."""
    ps = [list(SHARED), SHARED + [30, 31, 32, 33], list(SHARED), SHARED + [21, 22]]
    jrep, trep = serve_both(_specs(ps, n_new=6, arrival=1.2), ps=4, slots=1, tick=0.001)
    assert_same_report(jrep, trep, clocked=True)
    assert trep.requests[1].cached_tokens == 8 and trep.cached_tokens >= 8 + 7


def test_serve_same_batch_dedup_matches_jax():
    """Identical prompts admitted together share pages and skip prefill."""
    p = prompts((9,), seed=4)[0]
    jrep, trep = serve_both(_specs([p, list(p), p[:6]]), ps=4, prefix_cache=False)
    assert_same_report(jrep, trep)
    assert trep.requests[1].dedup_of == 0 and trep.cached_tokens >= 9


def test_serve_report_percentiles_exact_on_fake_clock():
    _, te = engines()
    from repro_torch.obs import FakeClock
    from repro_torch.serving.scheduler import Request

    reqs = [Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3, arrival=0.0),
            Request(rid=1, prompt=[4, 5], max_new_tokens=2, arrival=5.0)]
    rep = te.serve(reqs, clock=FakeClock())
    assert rep.wall_time == 5.0 and rep.ttft_values() == [0.0, 0.0] and rep.latency_values() == [0.0, 0.0]
    assert rep.ttft_p50 == rep.ttft_p99 == 0.0 and rep.tokens_per_step >= 1.0
