"""The port's ``Engine.serve`` with observability on, against the JAX
package's, float32 compute, packed W4 + RaZeR KV, reduced llama3_2_3b
(``_torch_serve_cases``' engines).

* ``metrics=`` on a ``FakeClock(tick=0.001)``: the registry's snapshot and
  Prometheus text equal the JAX engine's (pool and cache gauges, the
  prefill and decode-step histograms read at the reference's clock reads,
  TTFT / latency / TPOT and the token counters), vanilla and
  ``speculate_k=2``; tokens equal with observability on and off.
* ``kv_audit=``: fed the JAX engine's own prefill caches (a tee of the JAX
  auditor), the port's ``KVAuditor`` reports the JAX numbers (integers
  exact, floats within 1e-6 relative); after the port's own serve its
  integers equal the JAX auditor's and its pooled SQNR is within 1e-6
  relative.  The per-page maxima are single elements of K/V that the two
  engines compute in different f32 summation orders (logits within 3e-7,
  ``tests/test_torch_engine.py``), so they are held within 1e-5 relative.
  Layer-group selection and the sampling bounds are checked on synthetic
  two-group caches against the JAX auditor.
* ``profile_dir=`` writes a Chrome trace on the CPU.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_obs_cases import assert_reports_match
from _torch_serve_cases import engines, prompts, requests
from repro.obs import FakeClock as JaxFakeClock
from repro.obs import KVAuditor as JaxKVAuditor
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import Tracer as JaxTracer
from repro_torch.obs import FakeClock, KVAuditor, MetricsRegistry, Tracer

INTS = ("prefills_seen", "sample_every", "pages_sampled", "tokens_sampled", "pages_dropped")


def _specs():
    """Staggered arrivals, a shared 8-token head (a prefix-cache hit) and a
    prompt past one page."""
    ps = prompts((5, 9, 17, 5, 12))
    ps[3] = ps[0] + [3, 4]
    return [(p, 4, 0.001 * i, -1) for i, p in enumerate(ps)]


class _TeeAuditor(JaxKVAuditor):
    """The JAX auditor that also hands each prefill's caches, as torch
    tensors in the port's per-layer layout, to a port auditor."""

    def __init__(self, port, **kw):
        super().__init__(**kw)
        self.port = port

    def observe_prefill(self, seq_id, caches, length, start, page_size):
        super().observe_prefill(seq_id, caches, length, start, page_size)
        layers = [{name: torch.from_numpy(np.array(g[name][i])) for name in ("k", "v")}
                  for g in caches for i in range(g["k"].shape[0])]
        self.port.observe_prefill(seq_id, layers, length, start, page_size,
                                  group_sizes=[g["k"].shape[0] for g in caches])


@pytest.mark.parametrize("k", [0, 2])
def test_serve_metrics_equal_jax_on_fake_clock(k):
    je, te = engines("w4_kv")
    kw = dict(speculate_k=k, draft_policy="bf16") if k else {}
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jrep = je.serve(requests(_specs(), False), clock=JaxFakeClock(tick=0.001), metrics=jreg, trace=JaxTracer(),
                    **kw)
    trep = te.serve(requests(_specs(), True), clock=FakeClock(tick=0.001), metrics=treg, trace=Tracer(), **kw)
    assert trep.outputs == jrep.outputs
    assert treg.snapshot() == jreg.snapshot()
    assert treg.expose() == jreg.expose()
    snap = treg.snapshot()
    assert snap["serve_ttft_seconds"]["series"][0]["count"] == len(trep.requests)
    assert snap["serve_tokens_total"]["series"][0]["value"] == trep.new_tokens
    assert snap["serve_decode_step_seconds"]["series"][0]["count"] == trep.decode_steps
    # at the end no sequence holds a page: the live ones are the prefix cache's
    live = [s for s in snap["pool_pages"]["series"] if s["labels"]["state"] == "live"]
    assert live[0]["value"] == snap["cache_radix_nodes"]["series"][0]["value"] > 0
    assert te.serve(requests(_specs(), True), **kw).outputs == trep.outputs  # observability off


def test_kv_audit_equals_jax_on_the_same_caches_and_after_serve():
    je, te = engines("w4_kv")
    teed, own = KVAuditor(sample_every=1), KVAuditor(sample_every=1)
    jaud = _TeeAuditor(teed, sample_every=1)
    jrep = je.serve(requests(_specs(), False), kv_audit=jaud)
    trep = te.serve(requests(_specs(), True), kv_audit=own)
    base = te.serve(requests(_specs(), True))
    assert trep.outputs == base.outputs == jrep.outputs  # read-only: tokens unchanged
    want = jaud.snapshot()
    assert want["pages_sampled"] > 0 and want["prefills_seen"] == len(_specs())
    assert_reports_match(want, teed.snapshot(), rel=1e-6)
    got = own.snapshot()
    assert {k: got[k] for k in INTS} == {k: want[k] for k in INTS}
    assert abs(got["sqnr_db"] - want["sqnr_db"]) <= 1e-6 * want["sqnr_db"]
    assert_reports_match({"max_abs_err": want["max_abs_err"], "pages": want["pages"]},
                         {"max_abs_err": got["max_abs_err"], "pages": got["pages"]}, rel=1e-5)


def _two_group_caches(seed, counts=(1, 2), s=16, kvh=2, hd=32):
    rng = np.random.default_rng(seed)
    jax_caches = [{name: rng.standard_normal((c, 1, s, kvh, hd)).astype(np.float32) * 3 for name in ("k", "v")}
                  for c in counts]
    port_layers = [{name: torch.from_numpy(g[name][i]) for name in ("k", "v")}
                   for g in jax_caches for i in range(g["k"].shape[0])]
    return [{k: jnp.asarray(v) for k, v in g.items()} for g in jax_caches], port_layers, list(counts)


@pytest.mark.parametrize("group", [0, 1])
def test_kv_audit_group_selection_and_bounds_equal_jax(group):
    """Two layer groups (1 + 2 layers), prefills at offsets 0 and 5 with a
    partial last page, every other prefill sampled, the page list capped."""
    jaud = JaxKVAuditor(sample_every=2, max_pages=3, group=group)
    taud = KVAuditor(sample_every=2, max_pages=3, group=group)
    for seq, (length, start) in enumerate([(13, 0), (9, 0), (21, 5), (16, 0), (30, 3)]):
        jc, tc, sizes = _two_group_caches(seq)
        jaud.observe_prefill(seq, jc, length, start, 4)
        taud.observe_prefill(seq, tc, length, start, 4, group_sizes=sizes)
    want, got = jaud.snapshot(), taud.snapshot()
    assert want["pages_dropped"] > 0 and want["prefills_seen"] == 5
    assert_reports_match(want, got, rel=1e-6)
    reg, jreg = MetricsRegistry(), JaxRegistry()
    taud.install(reg, stage="engine")
    jaud.install(jreg, stage="engine")
    assert_reports_match(jreg.snapshot(), reg.snapshot(), rel=1e-6)
    with pytest.raises(ValueError, match="sample_every"):
        KVAuditor(sample_every=0)


def test_profile_dir_writes_a_chrome_trace_on_the_cpu(tmp_path):
    _, te = engines("w4_kv")
    rep = te.serve(requests(_specs()[:2], True), profile_dir=str(tmp_path / "prof"))
    doc = json.loads((tmp_path / "prof" / "serve_trace.json").read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert rep.outputs == te.serve(requests(_specs()[:2], True)).outputs
