"""The port's paged KV pool, scheduler and prefix cache on the CPU, mirroring
the JAX package's unit tests (``tests/test_paged_serving.py:35-74`` and
``:253-294``, ``tests/test_prefix_cache.py:43-89`` and ``:129-257``,
``tests/test_speculative.py:43-139``), and ``write_prefill`` byte for byte
against the JAX pool (every page but the null page, whose bytes depend on
the order of duplicate writes)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.serving.pagepool import KVPagePool as JaxPool
from repro.serving.pagepool import PagePoolConfig as JaxPoolConfig
from repro_torch.configs import get_config as torch_get_config
from repro_torch.obs import FakeClock, Tracer, percentile
from repro_torch.serving.pagepool import NULL_PAGE, KVPagePool, PagePoolConfig
from repro_torch.serving.prefixcache import PrefixCache
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerConfig

SHARED = [7, 3, 9, 4, 2, 8, 6, 1]  # two full pages at page size 4
KV_NAMES = ("k_codes", "k_meta", "v_codes", "v_meta")


def _cfg():
    return dataclasses.replace(torch_get_config("llama3_2_3b").reduced(), num_kv_heads=2)


def _pool(num_pages=32, ps=4, max_len=64):
    return KVPagePool(_cfg(), PagePoolConfig(num_pages=num_pages, page_size=ps, max_len=max_len), device="cpu")


def _caches(rng, s, count=3, kvh=2, hd=16):
    """Per-layer prefill K/V (1, s, KVH, hd) f32, the port's layout."""
    return [{"k": torch.from_numpy(rng.standard_normal((1, s, kvh, hd)).astype(np.float32)),
             "v": torch.from_numpy(rng.standard_normal((1, s, kvh, hd)).astype(np.float32))} for _ in range(count)]


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------
def test_pool_alloc_free_append_cycle():
    pool = _pool(num_pages=6, ps=8, max_len=48)
    pages = pool.allocate(0, 17)
    assert len(pages) == 3 and NULL_PAGE not in pages and pool.num_free_pages == 3
    assert len(pool.append(0, 25)) == 1 and pool.append(0, 26) == [] and pool.num_free_pages == 2
    pool.allocate(1, 8)
    pool.release(0)
    assert pool.num_free_pages == 5 and set(pool.allocate(2, 40)) & set(pages)


def test_pool_exhaustion_and_misuse_errors():
    pool = _pool(num_pages=8)
    pool.allocate(0, 10)
    with pytest.raises(ValueError, match="double allocation.*release"):
        pool.allocate(0, 4)
    with pytest.raises(ValueError, match="unknown sequence 5.*allocate"):
        pool.append(5, 8)
    with pytest.raises(ValueError, match="unknown sequence 5"):
        pool.release(5)
    with pytest.raises(ValueError, match="not allocated"):
        pool.incref(7)
    with pytest.raises(ValueError, match="exceed"):
        pool.allocate(1, 4, shared=pool.sequence_pages(0)[:2])
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.allocate(2, 30)
    with pytest.raises(ValueError, match="max_len"):
        pool.allocate(3, 65)
    pool.release(0)
    with pytest.raises(ValueError, match="no owners"):
        pool.decref(2)


def test_pool_page_table_layout_and_views():
    pool = _pool(num_pages=8, ps=8, max_len=48)
    pool.allocate(7, 20)
    row = pool.page_row(7)
    assert row.shape == (6,) and (row[:3] != NULL_PAGE).all() and (row[3:] == NULL_PAGE).all()
    table = pool.page_table([7, None])
    assert table.dtype == torch.int32 and (table[1] == NULL_PAGE).all()
    # the per-layer arrays are views of the pool's buffers, in the JAX layout
    group = pool.caches[0]
    assert tuple(group["k_codes"].shape) == (3, 9, 8, 2, 8) and tuple(group["k_meta"].shape) == (3, 9, 8, 2, 1)
    pool.layers[1]["v_codes"][4, 2] = 7
    assert int(group["v_codes"][1, 4, 2].min()) == 7


def test_pool_refcounts_shared_pages_across_release_order():
    pool = _pool(num_pages=8)
    a = pool.allocate(0, 10)
    pool.allocate(1, 10, shared=a[:2])
    assert [pool.refcount(p) for p in a] == [2, 2, 1]
    free0 = pool.num_free_pages
    pool.release(0)
    assert pool.num_free_pages == free0 + 1 and [pool.refcount(p) for p in a[:2]] == [1, 1]
    pool.release(1)
    assert pool.num_free_pages == 8
    a = pool.allocate(0, 10)
    pool.allocate(1, 10, shared=a[:2])
    pool.release(1)
    assert [pool.refcount(p) for p in a] == [1, 1, 1]
    pool.release(0)
    assert pool.num_free_pages == 8


def test_pool_cow_fork_is_deferred_and_isolated():
    """The copy snapshots the source at flush_forks(), after the donor's
    write, and later writes to the copy leave the source alone."""
    rng = np.random.default_rng(0)
    pool = _pool(num_pages=8)
    src = pool.allocate(0, 8)[0]
    forked = pool.allocate(1, 8, cow_src=src)
    assert pool.refcount(src) == 2
    pool.write_prefill(0, _caches(rng, 8), 8)
    pool.flush_forks(1)
    assert pool.refcount(src) == 1 and forked[0] != src
    group = pool.caches[0]
    snap = {k: v[:, src].clone() for k, v in group.items()}
    assert all(torch.equal(group[k][:, forked[0]], snap[k]) for k in KV_NAMES)
    pool.write_prefill(1, _caches(rng, 8), 4)
    assert all(torch.equal(group[k][:, src], snap[k]) for k in KV_NAMES)
    assert not torch.equal(group["k_codes"][:, forked[0]], snap["k_codes"])


def test_truncate_append_cycle_and_cow_cancel():
    pool = _pool(num_pages=8, ps=2, max_len=16)
    pool.allocate(0, 6)
    assert len(pool.truncate(0, 3)) == 1 and pool.truncate(0, 3) == [] and pool.truncate(0, 4) == []
    assert len(pool.truncate(0, 0)) == 2 and pool.sequence_pages(0) == []
    pool.release(0)
    with pytest.raises(ValueError, match="unknown sequence"):
        pool.truncate(3, 0)
    a = pool.allocate(0, 4)
    with pytest.raises(ValueError, match="negative"):
        pool.truncate(0, -1)
    pool.allocate(1, 4, shared=a)
    pool.truncate(1, 2)  # drops seq 1's claim on the shared second page only
    assert pool.refcount(a[1]) == 1 and a[1] not in pool._free
    pool.allocate(2, 4, shared=a[:1], cow_src=a[1])
    assert pool.refcount(a[1]) == 2
    pool.truncate(2, 2)  # pops the fork's destination: the fork is cancelled
    pool.flush_forks(2)
    assert pool.refcount(a[1]) == 1
    pool.append(1, 3)
    free0 = pool.num_free_pages
    for _ in range(5):
        pool.append(1, 7)
        pool.truncate(1, 3)
    assert pool.num_free_pages == free0


@pytest.mark.parametrize("ps,start,length", [(4, 0, 13), (16, 0, 13), (4, 6, 13), (3, 5, 11)])
def test_write_prefill_bytes_match_jax_pool(ps, start, length):
    """Same allocation on both pools, then the same prefill K/V written:
    identical wire bytes on every page but the null page."""
    rng = np.random.default_rng(ps + start)
    jcfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), num_kv_heads=2)
    jpool = JaxPool(jcfg, JaxPoolConfig(num_pages=12, page_size=ps, max_len=64))
    tpool = KVPagePool(_cfg(), PagePoolConfig(num_pages=12, page_size=ps, max_len=64), device="cpu")
    for pool in (jpool, tpool):
        pool.allocate(0, 4)  # an earlier sequence, so seq 1's pages do not start at 1
        pool.allocate(1, 20)
    caches = _caches(rng, 16)
    jcaches = [{"k": jnp.asarray(np.stack([c["k"].numpy() for c in caches])),
                "v": jnp.asarray(np.stack([c["v"].numpy() for c in caches]))}]  # (count, 1, S, KVH, hd)
    jpool.write_prefill(1, jcaches, length, start=start)
    tpool.write_prefill(1, caches, length, start=start)
    for name in KV_NAMES:
        want = np.asarray(jpool.caches[0][name])[:, 1:]
        got = tpool.caches[0][name].numpy()[:, 1:]
        np.testing.assert_array_equal(got, want)
    assert tpool.caches[0]["k_codes"][:, tpool.sequence_pages(1)].any()


# ---------------------------------------------------------------------------
# radix tree
# ---------------------------------------------------------------------------
def test_radix_match_insert_and_branching():
    pool = _pool(num_pages=16)
    cache = PrefixCache(pool)
    prompt = SHARED + [11, 12]
    pages = pool.allocate(0, len(prompt))
    assert cache.match(prompt).cached_len == 0
    cache.insert(prompt, pages)
    assert cache.cached_pages == 2 and [pool.refcount(p) for p in pages] == [2, 2, 1]
    m = cache.match(list(prompt))
    assert m.pages == (pages[0], pages[1]) and m.cow_page is None and m.cached_len == 8
    m2 = cache.match(SHARED[:5] + [99, 98, 97])
    assert m2.pages == (pages[0],) and m2.partial == 1 and m2.cached_len == 5
    assert cache.match([99] + SHARED).cached_len == 0
    pages_b = pool.allocate(1, 8, shared=[pages[0]])
    cache.insert(SHARED[:4] + [99, 98, 97, 96], pages_b)
    assert cache.cached_pages == 3 and len(cache.root.children) == 1
    assert len(next(iter(cache.root.children.values())).children) == 2


def test_radix_match_prefix_longer_than_prompt():
    pool = _pool(num_pages=16)
    cache = PrefixCache(pool)
    pages = pool.allocate(0, 12)
    cache.insert(SHARED + [11, 12, 13, 14], pages)
    m = cache.match(SHARED[:6])
    assert m.pages == (pages[0],) and m.cow_page == pages[1] and m.cached_len == 5
    m2 = cache.match(SHARED)
    assert m2.pages == (pages[0],) and m2.cow_page == pages[1] and m2.cached_len == 7


def test_radix_eviction_lru_refcount_and_cascade():
    pool = _pool(num_pages=8)
    cache = PrefixCache(pool)
    events = []
    cache.add_listener(lambda ev, path: events.append((ev, len(path))))
    pages = pool.allocate(0, 12)
    cache.insert(SHARED + [11, 12, 13, 14], pages)
    assert cache.evictable_pages() == 0 and cache.evict(3) == 0
    pool.release(0)
    assert cache.evictable_pages() == 3
    assert cache.evict(1) == 1 and cache.cached_pages == 2
    assert cache.evict(5, protect=[pages[0]]) == 1 and cache.cached_pages == 1
    assert cache.evict(5) == 1 and cache.cached_pages == 0 and pool.num_free_pages == 8
    assert events == [("insert", 3), ("evict", 3), ("evict", 2), ("evict", 1)]
    a, b = pool.allocate(0, 4), pool.allocate(1, 4)
    cache.insert([1, 2, 3, 4], a)
    cache.insert([5, 6, 7, 8], b)
    pool.release(0)
    pool.release(1)
    cache.match([1, 2, 3, 4, 9])  # bump branch a
    cache.evict(1)
    assert [n.page for n in cache._nodes()] == [a[0]]


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------
def _sched(cache=False, num_pages=32, ps=8, max_len=48, slots=2, budget=512, k=0):
    pool = _pool(num_pages=num_pages, ps=ps, max_len=max_len)
    pc = PrefixCache(pool) if cache else None
    return Scheduler(SchedulerConfig(max_slots=slots, prefill_token_budget=budget, speculate_k=k), pool,
                     cache=pc), pool, pc


def test_scheduler_slots_fifo_budget_and_arrivals():
    sched, _, _ = _sched(slots=2)
    for i in range(3):
        sched.submit(Request(rid=i, prompt=[i + 1] * 4, max_new_tokens=4))
    admitted = sched.admit(0.0)
    assert [r.rid for r in admitted] == [0, 1]
    for r in admitted:
        sched.start(r, first_token=5, now=0.0)
    assert sched.admit(0.0) == []
    for _ in range(3):
        sched.post_decode([9] * 2, now=0.2)
    assert [r.rid for r in sched.admit(0.3)] == [2]
    sched, _, _ = _sched(slots=4, budget=10)
    sched.submit(Request(rid=0, prompt=[1] * 6, max_new_tokens=2))
    sched.submit(Request(rid=1, prompt=[2] * 6, max_new_tokens=2))
    sched.submit(Request(rid=2, prompt=[1] * 2, max_new_tokens=2, arrival=5.0))
    assert [r.rid for r in sched.admit(0.0)] == [0]
    assert [r.rid for r in sched.admit(0.0)] == [1]
    assert sched.admit(0.0) == [] and [r.rid for r in sched.admit(6.0)] == [2]


def test_scheduler_submit_validation_and_backpressure():
    sched, _, _ = _sched(max_len=16, num_pages=2)
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request(rid=0, prompt=[], max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(Request(rid=1, prompt=[1] * 12, max_new_tokens=8))
    big, _, _ = _sched(max_len=48, num_pages=2)
    with pytest.raises(ValueError, match="num_pages"):
        big.submit(Request(rid=2, prompt=[1] * 30, max_new_tokens=10))
    big.submit(Request(rid=0, prompt=[1], max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        big.submit(Request(rid=0, prompt=[2], max_new_tokens=2))
    sched, _, _ = _sched(slots=4, num_pages=3)
    sched.submit(Request(rid=0, prompt=[1] * 10, max_new_tokens=6))
    sched.submit(Request(rid=1, prompt=[2] * 10, max_new_tokens=6))
    admitted = sched.admit(0.0)
    assert [r.rid for r in admitted] == [0]
    sched.start(admitted[0], 7, 0.0)
    assert sched.admit(0.0) == []
    for _ in range(5):
        sched.post_decode([3, 0, 0, 0], now=0.1)
    assert [r.rid for r in sched.admit(0.2)] == [1]


def test_scheduler_charges_only_uncached_suffix():
    sched, pool, _ = _sched(cache=True, ps=4, num_pages=16, slots=4, budget=6)
    sched.submit(Request(rid=0, prompt=SHARED[:6], max_new_tokens=2))
    [a] = sched.admit(0.0)
    sched.start(a, 5, 0.0)
    sched.submit(Request(rid=1, prompt=SHARED[:4] + [11, 12, 13, 14], max_new_tokens=2))
    sched.submit(Request(rid=2, prompt=SHARED[:4] + [21, 22], max_new_tokens=2))
    admitted = sched.admit(0.0)
    assert [r.cached_tokens for r in admitted] == [4, 4]
    assert pool.sequence_pages(1)[0] == pool.sequence_pages(0)[0]
    assert pool.refcount(pool.sequence_pages(0)[0]) >= 3


def test_scheduler_evicts_under_pressure_and_falls_back_matchless():
    sched, pool, cache = _sched(cache=True, num_pages=6, ps=4, max_len=32)
    sched.submit(Request(rid=0, prompt=SHARED, max_new_tokens=1))
    [a] = sched.admit(0.0)
    sched.start(a, 5, 0.0)
    assert cache.cached_pages == 2 and pool.num_free_pages == 4
    sched.submit(Request(rid=1, prompt=[50, 51, 52], max_new_tokens=4))
    [b] = sched.admit(0.0)
    sched.start(b, 6, 0.0)
    decoder_pages = pool.sequence_pages(1)
    sched.submit(Request(rid=2, prompt=[60, 61, 62, 63, 64, 65], max_new_tokens=6))
    [c] = sched.admit(0.1)
    assert c.rid == 2 and cache.evictions >= 1 and pool.sequence_pages(1) == decoder_pages
    sched, pool, _ = _sched(cache=True, num_pages=3, ps=4, max_len=12)
    sched.submit(Request(rid=0, prompt=SHARED, max_new_tokens=1))
    [a] = sched.admit(0.0)
    sched.start(a, 5, 0.0)
    sched.submit(Request(rid=1, prompt=list(SHARED), max_new_tokens=4))
    [b] = sched.admit(0.0)
    assert b.rid == 1 and b.cached_tokens in (0, 7) and len(pool.sequence_pages(1)) == 3


def test_scheduler_reserves_speculative_headroom():
    sched, pool, _ = _sched(num_pages=6, ps=2, max_len=12, slots=4, k=2)
    for rid in (0, 1):
        sched.submit(Request(rid=rid, prompt=[1, 2, 3, 4 + rid], max_new_tokens=4))
    admitted = sched.admit(0.0)
    assert [r.rid for r in admitted] == [0]
    pool.append(0, 7)
    pool.truncate(0, 4)
    assert pool.num_free_pages >= 2 and sched.admit(0.0) == []
    assert sched._available_pages() <= pool.num_free_pages - 2
    sched.start(admitted[0], 9, 0.0)
    sched.post_verify([[7, 7], [], [], []], 0.0)
    assert sched.admit(0.0) == []
    sched.post_verify([[7], [], [], []], 0.0)
    assert [r.rid for r in sched.admit(0.0)] == [1]
    with pytest.raises(ValueError, match="speculate_k"):
        Scheduler(SchedulerConfig(speculate_k=3), _pool(num_pages=8, ps=2, max_len=10)).submit(
            Request(rid=0, prompt=[1] * 4, max_new_tokens=4))


def test_post_verify_trims_at_eos_and_max_new():
    sched, pool, _ = _sched(num_pages=8, ps=2, max_len=16)
    sched.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=4, eos_id=99))
    sched.submit(Request(rid=1, prompt=[3, 4], max_new_tokens=3))
    a, b = sched.admit(0.0)
    sched.start(a, 5, 0.0)
    sched.start(b, 6, 0.0)
    done = sched.post_verify([[7, 99, 8], [7, 8, 9]], 0.0)
    assert a.out_tokens == [5, 7, 99] and b.out_tokens == [6, 7, 8]
    assert {r.rid for r in done} == {0, 1} and pool.pages_in_use == 0


def test_scheduler_same_batch_dedup_shares_and_forks():
    sched, pool, _ = _sched(ps=4, slots=4)
    sched.submit(Request(rid=0, prompt=SHARED + [1, 2], max_new_tokens=2))
    sched.submit(Request(rid=1, prompt=SHARED + [1, 2], max_new_tokens=2))
    a, b = sched.admit(0.0)
    assert b.dedup_of == 0 and b.cached_tokens == 10
    assert pool.sequence_pages(1)[:2] == pool.sequence_pages(0)[:2]
    assert pool.sequence_pages(1)[2] != pool.sequence_pages(0)[2]


# ---------------------------------------------------------------------------
# observability seams
# ---------------------------------------------------------------------------
def test_fake_clock_tracer_and_percentile():
    clock = FakeClock(start=1.0, tick=0.5)
    assert clock.now() == 1.0 and clock.now() == 1.5
    clock.sleep(2.0)
    assert clock.now() == 4.0
    with pytest.raises(ValueError):
        clock.advance(-1)
    tracer = Tracer(clock=FakeClock(tick=1.0))
    with tracer.span("decode_step", batch=2):
        pass
    tracer.instant("admit", ts=0.5, rid=3)
    events = tracer.to_json()["traceEvents"]
    assert [e["ph"] for e in events] == ["B", "E", "i"] and events[1]["ts"] - events[0]["ts"] == 1_000_000
    assert percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.0 and percentile([3.0, 1.0, 2.0, 4.0], 95) == 4.0
    assert percentile([], 99) == 0.0
