"""The port's wire-format page shipments and disaggregation router against
the JAX package's (``tests/test_disagg.py`` has the reference's cases).

Shipments: the same random wire bytes written into the same pages of a JAX
pool and a port pool export to identical buffers (per arch and page size,
full and partial last pages, and with a copy-on-write fork pending), and
import into another pool bit for bit; the validation errors are the
reference's.  Router: the same events and calls give the same placements,
loads and views in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serving.disagg import RadixView as JaxRadixView
from repro.serving.disagg import Router as JaxRouter
from repro.serving.pagepool import KVPagePool as JaxPool
from repro.serving.pagepool import PagePoolConfig as JaxPoolConfig
from repro.serving.prefixcache import PrefixCache as JaxPrefixCache
from repro_torch.configs import get_config
from repro_torch.serving.disagg import RadixView, Router
from repro_torch.serving.pagepool import KVPagePool, PagePoolConfig, PageShipment
from repro_torch.serving.prefixcache import PrefixCache


def _pools(arch="llama3_2_3b", num_pages=16, ps=4, max_len=64):
    """A JAX pool and a port pool of one reduced config."""
    jp = JaxPool(jax_get_config(arch).reduced(), JaxPoolConfig(num_pages=num_pages, page_size=ps, max_len=max_len))
    tp = KVPagePool(get_config(arch).reduced(), PagePoolConfig(num_pages=num_pages, page_size=ps, max_len=max_len),
                    device="cpu")
    return jp, tp


def _fill_random(jp, tp, pages, seed):
    """The same random wire bytes into the given physical pages of both
    pools' buffers (a shipment is byte transport: no model needed)."""
    rng = np.random.default_rng(seed)
    ids = jnp.asarray(np.asarray(pages, np.int32))
    for gi, c in enumerate(jp.caches):
        new = {}
        for k, buf in c.items():
            vals = rng.integers(0, 256, size=(buf.shape[0], len(pages)) + buf.shape[2:], dtype=np.uint8)
            new[k] = buf.at[:, ids].set(jnp.asarray(vals))
            tp.caches[gi][k][:, torch.as_tensor(pages)] = torch.from_numpy(vals)
        jp.caches[gi] = new


def _port_bytes(pool, pages):
    ids = torch.as_tensor(pages)
    return [{k: buf[:, ids].numpy() for k, buf in c.items()} for c in pool.caches]


def _assert_same_shipment(jship, tship: PageShipment):
    assert (tship.seq_id, tship.n_tokens, tship.page_size, tship.n_pages) == \
        (jship.seq_id, jship.n_tokens, jship.page_size, jship.n_pages)
    assert (tship.nbytes, tship.bf16_bytes) == (jship.nbytes, jship.bf16_bytes)
    assert len(tship.buffers) == len(jship.buffers)
    for jb, tb in zip(jship.buffers, tship.buffers):
        assert set(tb) == set(jb)
        for k in jb:
            assert tb[k].device.type == "cpu" and tb[k].dtype == torch.uint8
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


@pytest.mark.parametrize("arch,ps", [("llama3_2_3b", 16), ("llama3_2_3b", 4), ("qwen3_8b", 8), ("dbrx_132b", 8)])
def test_shipment_bytes_equal_jax_and_roundtrip(arch, ps):
    """export equals the JAX export byte for byte (a partial last page, and
    an explicit ``n_tokens``), and an import into another pool lands the
    same bytes in other physical pages."""
    jp, tp = _pools(arch, ps=ps)
    for pool in (jp, tp):
        pool.allocate(5, ps + 1)  # the sequence's pages are not the first ones
    n_tok = 2 * ps + ps // 2
    pages = tp.allocate(0, n_tok)
    assert jp.allocate(0, n_tok) == pages
    _fill_random(jp, tp, pages, seed=1)
    tship = tp.export_pages(0)
    _assert_same_shipment(jp.export_pages(0), tship)
    assert tship.n_pages == len(pages) and tship.n_tokens == len(pages) * ps
    _assert_same_shipment(jp.export_pages(0, n_tokens=ps), tp.export_pages(0, n_tokens=ps))
    _assert_same_shipment(jp.export_pages(page_ids=pages[1:]), tp.export_pages(page_ids=pages[1:]))

    _, dst = _pools(arch, ps=ps)
    dst.allocate(99, 3 * ps + 1)
    new_pages = dst.import_pages(tship, seq_id=7)
    assert new_pages != pages
    for want, got in zip(_port_bytes(tp, pages), _port_bytes(dst, new_pages)):
        for k in want:
            np.testing.assert_array_equal(want[k], got[k])


def test_shipment_mid_cow_fork_equals_jax():
    """A sequence with a pending copy-on-write fork: export flushes it
    first, in both packages, and ships the sequence's own pages."""
    jp, tp = _pools(ps=4)
    donor = tp.allocate(0, 10)
    assert jp.allocate(0, 10) == donor
    _fill_random(jp, tp, donor, seed=2)
    for pool in (jp, tp):
        pool.allocate(1, 10, shared=donor[:2], cow_src=donor[2])
    assert tp.refcount(donor[2]) >= 2  # the fork is deferred
    tship = tp.export_pages(1)
    _assert_same_shipment(jp.export_pages(1), tship)
    own = tp.sequence_pages(1)
    assert own[2] != donor[2]
    np.testing.assert_array_equal(_port_bytes(tp, [own[2]])[0]["k_codes"], _port_bytes(tp, [donor[2]])[0]["k_codes"])
    _, dst = _pools(ps=4)
    got = _port_bytes(dst, dst.import_pages(tship, seq_id=0))
    for w, g in zip(_port_bytes(tp, own), got):
        for k in w:
            np.testing.assert_array_equal(w[k], g[k])


def test_gather_sequence_equals_jax():
    jp, tp = _pools("qwen3_8b", ps=4)
    pages = tp.allocate(3, 11)
    assert jp.allocate(3, 11) == pages
    _fill_random(jp, tp, pages, seed=4)
    jk, jv = jp.gather_sequence(3, 11)
    tk, tv = tp.gather_sequence(3, 11)
    assert tuple(tk.shape) == tuple(jk.shape)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_shipment_reserve_and_validation_errors():
    """The reference's errors: one of seq_id / page_ids, unknown sequence,
    pages that cannot cover n_tokens, page size, reserve, layout; and the
    transfer costs 4.5/16 of bf16 exactly."""
    _, pool = _pools(ps=4)
    pool.allocate(0, 8)
    with pytest.raises(ValueError, match="exactly one"):
        pool.export_pages(0, page_ids=[1])
    with pytest.raises(ValueError, match="exactly one"):
        pool.export_pages()
    with pytest.raises(ValueError, match="unknown sequence"):
        pool.export_pages(3)
    with pytest.raises(ValueError, match="cannot cover"):
        pool.export_pages(page_ids=[1, 2], n_tokens=9)
    ship = pool.export_pages(0)
    _, other_ps = _pools(ps=8)
    with pytest.raises(ValueError, match="page_size"):
        other_ps.import_pages(ship, seq_id=0)
    _, dst = _pools(ps=4)
    with pytest.raises(ValueError, match="reserve"):
        dst.import_pages(ship, seq_id=0, reserve_tokens=4)
    pages = dst.import_pages(ship, seq_id=0, reserve_tokens=17)
    assert len(pages) == 5 and ship.n_pages == 2
    assert ship.nbytes / ship.bf16_bytes == 0.28125
    ship.buffers[0]["k_codes"] = ship.buffers[0]["k_codes"][:, :, :, :1]  # drop heads
    with pytest.raises(ValueError, match="arch"):
        _pools(ps=4)[1].import_pages(ship, seq_id=1)


# ---------------------------------------------------------------------------
# router: the reference's four cases, both packages side by side
# ---------------------------------------------------------------------------
def _chunks(tokens, ps=4):
    return tuple(tuple(tokens[i:i + ps]) for i in range(0, len(tokens), ps))


def _placement(p):
    return (p.prefill, p.decode, p.predicted_hit)


def _routers(n_prefill, n_decode, ps=4):
    return JaxRouter(n_prefill, n_decode, ps), Router(n_prefill, n_decode, ps)


def test_router_longest_hit_wins_as_jax():
    """Replica 2 holds two chunks of the prompt, replica 0 one: 2 wins
    despite its load; a partial-chunk tail counts, clamped to len - 1."""
    got = []
    for r in _routers(3, 1):
        r.listener(0)("insert", _chunks([1, 2, 3, 4]))
        r.listener(2)("insert", _chunks([1, 2, 3, 4, 5, 6, 7, 8]))
        r.prefill_load[2] = 100
        got.append([_placement(r.place(p)) for p in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6], [9, 9])])
    assert got[1] == got[0]
    assert got[1][:2] == [(2, 0, 8), (2, 0, 5)]


def test_router_load_tiebreak_and_assign_as_jax():
    prompt = [9, 9, 9, 9, 9]
    trail = []
    for r in _routers(3, 2):
        seen = []
        first = r.place(prompt)
        r.assign(first, len(prompt))
        seen.append((_placement(first), list(r.prefill_load), list(r.decode_load)))
        second = r.place(prompt)
        r.assign(second, len(prompt))
        r.prefill_done(first, len(prompt))
        r.retire(first)
        seen.append((_placement(second), list(r.prefill_load), list(r.decode_load)))
        seen.append((_placement(r.place(prompt)), r.placements, r.prompt_tokens, r.predicted_hit_rate))
        trail.append(seen)
    assert trail[1] == trail[0]
    assert trail[1][0][0][:2] == (0, 0) and trail[1][1][0][:2] == (1, 1)


def test_router_eviction_invalidates_view_as_jax():
    """Wired through each package's real PrefixCache listener."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    seen = []
    for pool, cache_cls, router in ((_pools(num_pages=8)[0], JaxPrefixCache, JaxRouter(1, 1, 4)),
                                    (_pools(num_pages=8)[1], PrefixCache, Router(1, 1, 4))):
        cache = cache_cls(pool, listener=router.listener(0))
        cache.insert(prompt, pool.allocate(0, len(prompt)))
        pool.release(0)
        hits = [router.views[0].match_len(prompt + [9])]
        for _ in range(2):
            cache.evict(1)
            hits.append(router.views[0].match_len(prompt + [9]))
        seen.append((hits, router.views[0].n_chunks, router.snapshot()))
    assert seen[1] == seen[0]
    assert seen[1][0] == [8, 4, 0]


def test_radix_view_remove_keeps_interior_nodes_as_jax():
    seen = []
    for view in (JaxRadixView(page_size=4), RadixView(page_size=4)):
        view.insert(_chunks([1, 2, 3, 4, 5, 6, 7, 8]))
        view.remove(_chunks([1, 2, 3, 4]))  # interior: its child would be orphaned
        a = view.match_len([1, 2, 3, 4, 5, 6, 7, 8, 9])
        view.remove(_chunks([9, 9, 9, 9]))  # unknown path: no-op
        view.remove(_chunks([1, 2, 3, 4, 5, 6, 7, 8]))  # leaf: removed
        seen.append((a, view.match_len([1, 2, 3, 4, 5, 6, 7, 8, 9]), view.n_chunks))
    assert seen[1] == seen[0] == (8, 4, 1)


def test_router_needs_a_replica_of_each_kind():
    with pytest.raises(ValueError, match="needs >= 1"):
        Router(0, 1, 4)
    with pytest.raises(ValueError, match="needs >= 1"):
        Router(1, 0, 4)
