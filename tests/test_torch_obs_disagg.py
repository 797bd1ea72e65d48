"""The port's ``serve_disagg(metrics=)`` against the JAX package's, float32,
packed W4 + RaZeR KV, reduced llama3_2_3b, 2 prefill + 2 decode replicas
on a ``FakeClock(tick=0.001)``: the registry's snapshot and Prometheus
text are equal (per-replica pool and cache gauges labelled by stage and
replica, the router's load, the stage ``disagg`` latency histograms and
token counters, ``disagg_shipments_total``, ``disagg_transfer_bytes_total``
and ``stage_busy_seconds``), the counters equal the report's, and the
tokens equal the run without metrics."""
import pytest

from _torch_serve_cases import engines, prompts, requests
from repro.obs import FakeClock as JaxFakeClock
from repro.obs import MetricsRegistry as JaxRegistry
from repro.serving.disagg import serve_disagg as jax_serve_disagg
from repro_torch.obs import FakeClock, MetricsRegistry
from repro_torch.serving.disagg import serve_disagg

FLEET = dict(n_prefill=2, n_decode=2, page_size=8)


def _specs():
    ps = prompts((6, 11, 17, 9, 25), seed=3)
    ps[2] = ps[1][:8] + ps[2]  # a shared page-aligned head
    return [(p, 4, 0.002 * i, -1) for i, p in enumerate(ps)]


@pytest.mark.parametrize("chunk", [8, 64])
def test_disagg_metrics_equal_jax(chunk):
    je, te = engines("w4_kv")
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jrep = jax_serve_disagg(je, requests(_specs(), False), chunk_tokens=chunk, clock=JaxFakeClock(tick=0.001),
                            metrics=jreg, **FLEET)
    trep = serve_disagg(te, requests(_specs(), True), chunk_tokens=chunk, clock=FakeClock(tick=0.001),
                        metrics=treg, **FLEET)
    assert trep.outputs == jrep.outputs
    assert treg.snapshot() == jreg.snapshot()
    assert treg.expose() == jreg.expose()
    snap = treg.snapshot()
    assert snap["disagg_shipments_total"]["series"][0]["value"] == trep.shipments == len(_specs())
    assert snap["disagg_transfer_bytes_total"]["series"][0]["value"] == trep.transfer_bytes
    stages = {s["labels"]["stage"] for s in snap["pool_pages"]["series"]}
    assert stages == {"prefill", "decode"}
    assert serve_disagg(te, requests(_specs(), True), chunk_tokens=chunk, **FLEET).outputs == trep.outputs
