"""The port's own serving invariants on the CPU, float32 compute, under the
packed W4 + RaZeR KV and W4A4 + KV policies: ``serve`` gives the greedy
tokens of ``generate``, the prefix cache on gives the tokens of the cache
off, and speculative decoding gives the tokens of vanilla decode, with
accept rate 1 for a draft equal to the target and 0 for an adversarial one.
Also the speculative plumbing of ``tests/test_speculative.py``."""
import numpy as np
import pytest
import torch

from _torch_serve_cases import SHARED, configs, port_engine, prompts
from repro_torch.core.policy import QuantPolicy
from repro_torch.serving.pagepool import KVPagePool, PagePoolConfig
from repro_torch.serving.scheduler import Request, SchedulerConfig
from repro_torch.serving.speculative import resolve_draft_policy


def _mk(ps, n_new=6, stagger=0.0):
    return [Request(rid=i, prompt=list(p), max_new_tokens=n_new, arrival=stagger * i) for i, p in enumerate(ps)]


@pytest.mark.parametrize("policy", ["w4_kv", "w4a4_kv"])
def test_serve_equals_generate(policy):
    eng = port_engine(policy)
    ps = prompts((5, 11, 17, 3, 24))
    rep = eng.serve(ps)
    assert rep.outputs == eng.generate(ps)
    assert rep.new_tokens == 5 * 8 and rep.peak_pages > 0 and rep.tokens_per_s > 0


def test_serve_equals_generate_with_slot_reuse_and_small_pages():
    eng = port_engine()
    ps = [[i + 1, i + 2, i + 3] for i in range(5)] + [list(range(1, 11))]
    rep = eng.serve(ps, sched_cfg=SchedulerConfig(max_slots=2),
                    pool_cfg=PagePoolConfig(num_pages=24, page_size=4, max_len=64))
    assert rep.peak_slots <= 2
    assert rep.outputs == eng.generate(ps)


@pytest.mark.parametrize("page_size", [3, 4, 16])
def test_prefix_cache_on_equals_off(page_size):
    """Aligned, partial-page (COW), super-prefix and miss split points; page
    size 3 puts every split mid-page."""
    eng = port_engine()
    ps = [SHARED + [11, 12, 13], SHARED + [14, 15], SHARED + [11, 12, 13, 14, 15],
          SHARED[:5] + [20, 21], list(SHARED), [40, 41, 42], SHARED + list(range(50, 70)),
          SHARED + list(range(50, 62)) + [99, 98]]
    pool_cfg = PagePoolConfig(num_pages=64, page_size=page_size, max_len=64)
    off = eng.serve(_mk(ps), pool_cfg=pool_cfg, prefix_cache=False)
    on = eng.serve(_mk(ps), pool_cfg=pool_cfg, prefix_cache=True)
    assert on.outputs == off.outputs
    assert on.cached_tokens > 0 and on.prefill_tokens + on.cached_tokens == sum(len(p) for p in ps)


def test_prefix_cache_hit_after_donor_finished_equals_off():
    eng = port_engine()
    pool_cfg = PagePoolConfig(num_pages=32, page_size=4, max_len=64)
    ps = [SHARED + [11, 12], SHARED + [21, 22]]
    kw = dict(pool_cfg=pool_cfg, sched_cfg=SchedulerConfig(max_slots=1))
    on = eng.serve(_mk(ps, stagger=1.2), prefix_cache=True, **kw)
    assert on.outputs == eng.serve(_mk(ps, stagger=1.2), prefix_cache=False, **kw).outputs
    assert on.cache_hits >= 1 and on.cached_tokens >= 8


@pytest.mark.parametrize("policy", ["w4_kv", "w4a4_kv"])
def test_speculative_same_policy_draft_accepts_everything(policy):
    eng = port_engine(policy)
    ps = prompts((5, 11, 17, 3))
    base = eng.serve(ps)
    for k in (1, 2, 3):
        rep = eng.serve(ps, speculate_k=k, draft_policy=eng.scfg.quant)
        assert rep.outputs == base.outputs
        assert rep.accept_rate == 1.0 and rep.speculate_k == k
        assert rep.decode_steps < base.decode_steps and rep.draft_steps == k * rep.decode_steps
        assert rep.tokens_per_step > 1.0


def test_speculative_adversarial_draft_accepts_nothing():
    eng = port_engine()
    ps = prompts((5, 9, 14))
    base = eng.serve(ps)
    rep = eng.serve(ps, speculate_k=2, draft_policy=lambda tok, cl, t: (tok + 1) % 256)
    assert rep.outputs == base.outputs
    assert rep.accept_rate == 0.0 and rep.accepted_drafts == 0 and rep.drafted_tokens > 0
    assert rep.decode_steps == base.decode_steps


def test_speculative_mixed_per_slot_acceptance():
    """Even slots get oracle drafts from a vanilla run, odd slots garbage."""
    eng = port_engine()
    ps = prompts((6, 6, 6, 6), seed=3)
    base = eng.serve(ps)
    outs = base.outputs

    def oracle_or_garbage(tok, cl, t):
        nxt = np.zeros_like(tok)
        for i in range(len(tok)):
            if i % 2 == 0 and i < len(outs) and cl[i] + 1 < len(outs[i]):
                nxt[i] = outs[i][cl[i] + 1]
        return nxt

    rep = eng.serve(ps, speculate_k=2, draft_policy=oracle_or_garbage)
    assert rep.outputs == base.outputs and 0.0 < rep.accept_rate < 1.0


@pytest.mark.parametrize("draft", ["nvfp4", "bf16"])
def test_speculative_cheap_draft_equals_vanilla_with_sharing_and_pressure(draft):
    """Shared prefixes, a same-batch duplicate, staggered arrivals and two
    slots, under W4A4 + KV."""
    eng = port_engine("w4a4_kv")
    base_p = prompts((16,), seed=4)[0]
    ps = [base_p, base_p[:12] + [5, 6, 7], list(base_p), base_p[:8], [3, 1, 4, 1, 5]]
    kw = dict(sched_cfg=SchedulerConfig(max_slots=2), pool_cfg=PagePoolConfig(num_pages=40, page_size=4, max_len=64))
    base = eng.serve(_mk(ps, stagger=0.002), **kw)
    rep = eng.serve(_mk(ps, stagger=0.002), speculate_k=2, draft_policy=draft, **kw)
    assert rep.outputs == base.outputs and rep.cached_tokens == base.cached_tokens > 0


def test_resolve_draft_policy_forms():
    assert resolve_draft_policy(None) == QuantPolicy.fakequant("nvfp4")
    assert resolve_draft_policy("nvfp4") == QuantPolicy.fakequant("nvfp4")
    assert resolve_draft_policy("bf16") == QuantPolicy.bf16()
    pol = QuantPolicy.packed()
    assert resolve_draft_policy(pol) is pol
    fn = lambda tok, cl, t: tok  # noqa: E731
    assert resolve_draft_policy(fn) is fn
    with pytest.raises(TypeError, match="draft_policy"):
        resolve_draft_policy(3)


def test_speculator_cached_per_policy_and_report_zeros_when_off():
    eng = port_engine()
    assert eng._speculator("nvfp4") is eng._speculator("nvfp4")
    assert eng._speculator("nvfp4") is not eng._speculator("bf16")
    with pytest.raises(ValueError, match="speculate_k"):
        eng.serve(prompts((4,)), speculate_k=-1)
    rep = eng.serve(prompts((4, 7)), prefix_cache=False)
    assert rep.speculate_k == rep.drafted_tokens == rep.cache_lookups == 0
    assert rep.accept_rate == rep.draft_overhead == rep.cache_hit_rate == 0.0


def test_bf16_draft_casts_the_dense_tree_once():
    """The bf16 draft holds the engine's dense weights cast to the compute
    dtype (the products the per-step cast would give), not the packed ones."""
    eng = port_engine()
    spec = eng._speculator("bf16")
    w = spec.draft_params["layers_0"][0]["mixer"]["wq"]
    assert isinstance(w, torch.Tensor) and w.dtype == configs()[1].cdtype
    assert torch.equal(w, eng.draft_source_params()["layers_0"][0]["mixer"]["wq"].to(w.dtype))


def test_serve_pool_refuses_to_run_silently_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks what happens on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVPagePool(configs()[1], PagePoolConfig(num_pages=4))
