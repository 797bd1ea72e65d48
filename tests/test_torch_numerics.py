"""The port's numerics audit against the JAX package's on hand-computed
micro tensors: the golden report byte for byte, the micro-block audits with
the numbers ``tests/test_numerics.py`` pins, the scale/meta bit fields, the
drift (exactly 0), the generic audit, the registry hook, the schema
validator, the metrics export (with its cardinality guard) and the trace
instants.  Every port result is also compared with the JAX function's on
the same inputs."""
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jax_packing
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.obs import FakeClock as JaxFakeClock
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import Tracer as JaxTracer
from repro.obs import numerics as jax_num
from repro_torch.core import registry
from repro_torch.core.packing import pack_stacked_weights, pack_weight, unpack_scale_meta_fields
from repro_torch.core.policy import QuantPolicy
from repro_torch.obs import FakeClock, MetricsRegistry, Tracer
from repro_torch.obs import numerics as num

GOLDEN = Path(__file__).parent / "data" / "quant_report_golden.json"

# two 16-element blocks with hand-derivable wire bytes (tests/test_numerics.py):
# A is exact under scale 1 with SV +5; B swaps the 5 for 5.25, one -0.25 error
_BLOCK_A = [0, 1, 2, 3, 4, 6, -1, -2, -3, -4, -6, 0.5, 1.5, -0.5, -1.5, 5.0]
_BLOCK_B = _BLOCK_A[:-1] + [5.25]
_SS_A, _SS_B, _ERR_SQ_B = 162.0, 164.5625, 0.0625


def _micro_w():
    return torch.stack([torch.tensor(_BLOCK_A), torch.tensor(_BLOCK_B)], dim=1)


def _wide_w():
    return torch.stack([torch.tensor(_BLOCK_A if i % 2 == 0 else _BLOCK_B) for i in range(16)], dim=1)


def _spec():
    return QuantPolicy.packed("razer").weight


def _jax(t):
    return jnp.asarray(t.numpy())


def _golden_params(as_jax=False):
    w = _wide_w()
    tree = {"embed": {"w": torch.zeros(4, 4)}, "blk": {"attn": {"wq": w}},
            "mlp": {"experts": {"w_in": torch.stack([w, w])}}}
    return jax.tree_util.tree_map(_jax, tree) if as_jax else tree


def _golden_report():
    return num.audit_model(_golden_params(), QuantPolicy.packed("razer"), model="micro")


def test_golden_report_byte_for_byte():
    got = json.dumps(_golden_report(), indent=1, sort_keys=True) + "\n"
    assert got == GOLDEN.read_text()
    assert num.validate_report(_golden_report()) == []


def test_micro_exact_block():
    w = torch.tensor(_BLOCK_A)[:, None]
    stats = num.razer_audit(pack_weight(w), w, _spec())
    assert stats["code_hist"] == [1] * 16
    assert stats["sv"] == {"blocks": 1, "block_rate": 1.0, "elements": 1, "element_rate": 0.0625,
                           "select_hist": [1, 0, 0, 0], "magnitudes": [5.0, 8.0]}
    assert stats["sqnr_db"] is None and stats["mse"] == 0.0 and stats["max_abs_err"] == 0.0
    assert stats["drift_max_abs"] == 0.0 and stats["n_blocks"] == 1 and stats["wire_bytes"] == 8 + 1 + 4
    jw = _jax(w)
    assert stats == jax_num.razer_audit(jax_packing.pack_weight(jw), jw, JaxPolicy.packed("razer").weight)


def test_micro_pinned_sqnr():
    w = _micro_w()
    stats = num.razer_audit(pack_weight(w), w, _spec())
    assert stats["sqnr_db"] == pytest.approx(10 * math.log10((_SS_A + _SS_B) / _ERR_SQ_B), abs=1e-6)
    assert stats["sqnr_db"] == 37.1808629
    assert stats["mse"] == _ERR_SQ_B / 32 and stats["max_abs_err"] == 0.25 and stats["drift_max_abs"] == 0.0
    assert stats["sv"]["blocks"] == 2 and stats["sv"]["elements"] == 2 and stats["sv"]["select_hist"] == [2, 0, 0, 0]
    assert stats["code_hist"] == [2] * 16 and stats["scale"]["underflow_blocks"] == 0
    jw = _jax(w)
    assert stats == jax_num.razer_audit(jax_packing.pack_weight(jw), jw, JaxPolicy.packed("razer").weight)


def test_micro_stacked_bank_and_gathered_layers():
    """A bank audits per expert entry; two layers' containers of one path
    gathered (the port's list of per-layer weights) audit as the
    reference's stacked leaf: entries 2, sums pooled, the same numbers."""
    w = _micro_w()
    bank = torch.stack([w, w])
    stats = num.razer_audit(pack_stacked_weights(bank), bank, _spec())
    assert stats["entries"] == 2 and stats["n_blocks"] == 4 and stats["sv"]["elements"] == 4
    assert stats["drift_max_abs"] == 0.0 and stats["max_abs_err"] == 0.25 and stats["sqnr_db"] == 37.1808629
    jb = _jax(bank)
    assert stats == jax_num.razer_audit(jax_packing.pack_stacked_weights(jb), jb, JaxPolicy.packed("razer").weight)
    gathered = num.razer_audit([pack_weight(w), pack_weight(w)], [w, w], _spec())
    assert gathered == stats
    banks = num.razer_audit([pack_stacked_weights(bank)] * 3, [bank] * 3, _spec())
    assert banks["entries"] == 6 and banks["code_hist"] == [3 * c for c in stats["code_hist"]] \
        and banks["sqnr_db"] == stats["sqnr_db"]


def test_micro_without_reference_is_telemetry_only():
    stats = num.razer_audit(pack_weight(_micro_w()), None, _spec())
    assert "sqnr_db" not in stats and "drift_max_abs" not in stats
    assert stats["code_hist"] == [2] * 16


@pytest.mark.parametrize("weight", [True, False])
def test_unpack_scale_meta_fields_equals_jax(weight):
    byte = torch.arange(256, dtype=torch.uint8)
    got = unpack_scale_meta_fields(byte, weight=weight)
    want = jax_packing.unpack_scale_meta_fields(jnp.arange(256, dtype=jnp.uint8), weight=weight)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("fmt", ["razer", "nvfp4"])
def test_generic_audit_equals_jax_with_zero_drift(fmt):
    """Two registry dispatches give identical numbers (drift 0); the value
    histogram, scales and SV telemetry equal the JAX audit's.  razer's
    fakequant reports ``sv``, nvfp4 none."""
    w = _rand((64, 8), 3)
    stats = num.generic_audit(torch.from_numpy(w), torch.from_numpy(w), QuantPolicy.fakequant(fmt).weight, axis=0)
    want = jax_num.generic_audit(jnp.asarray(w), jnp.asarray(w), JaxPolicy.fakequant(fmt).weight, axis=0)
    assert stats["drift_max_abs"] == 0.0 and stats["sqnr_db"] > 0
    assert ("sv" in stats) == (fmt == "razer")
    assert stats == want


def test_packed_vs_fakequant_drift_exactly_zero():
    """The wire decode and razer_quantize through the registry are the SAME
    numbers for a bf16 weight, on one entry and gathered over layers."""
    w = torch.from_numpy(_rand((128, 32), 4)).to(torch.bfloat16)
    assert num.razer_audit(pack_weight(w.float()), w, _spec())["drift_max_abs"] == 0.0
    ws = [torch.from_numpy(_rand((64, 48), s)) for s in (5, 6, 7)]
    assert num.razer_audit([pack_weight(x) for x in ws], ws, _spec())["drift_max_abs"] == 0.0


def test_registry_audit_hook_and_names():
    assert registry.get_format("razer").audit_fn is not None
    assert registry.get_format("nvfp4").audit_fn is None
    # the paper's two formats and the §5.1 baselines, as the JAX package
    # registers them
    assert registry.format_names() == ("fouroversix", "int4", "mxfp4", "nf4", "nvfp4", "razer")
    registry.register_format("scratch_fmt", registry.get_format("nvfp4").quantize)
    try:
        assert "scratch_fmt" in registry.format_names()
        spec = QuantPolicy.fakequant("scratch_fmt").weight
        w = torch.from_numpy(_rand((32, 16), 8))
        assert num.audit_layer("blk/w", w, w, spec)["value_hist"]  # the generic audit
    finally:
        registry.unregister_format("scratch_fmt")
    assert "scratch_fmt" not in registry.format_names()
    registry.unregister_format("scratch_fmt")  # absent: no error


def test_validate_report_catches_violations():
    rep = _golden_report()
    rep["schema"] = "bogus/v0"
    del rep["rollups"]
    rep["layers"][0]["mode"] = "quantum"
    bad = num.validate_report(rep)
    assert any("bogus" in b for b in bad) and any("rollups" in b for b in bad) and any("quantum" in b for b in bad)
    assert num.validate_report([]) != []
    assert bad == jax_num.validate_report(rep)


@pytest.mark.parametrize("max_layers", [256, 3])
def test_numerics_metrics_equal_jax(max_layers):
    """``install_numerics_metrics`` snapshots and exposition are equal,
    including the per-layer cardinality guard (8 layers into 3 series)."""
    rep = _golden_report()
    jrep = jax_num.audit_model(_golden_params(as_jax=True), JaxPolicy.packed("razer"), model="micro")
    assert rep == jrep
    if max_layers == 3:
        rep["layers"] = [dict(rep["layers"][0], path=f"l{i}") for i in range(8)]
    treg, jreg = MetricsRegistry(), JaxRegistry()
    num.install_numerics_metrics(treg, rep, max_layers=max_layers)
    jax_num.install_numerics_metrics(jreg, rep, max_layers=max_layers)
    assert treg.snapshot() == jreg.snapshot() and treg.expose() == jreg.expose()
    assert treg.snapshot()["quant_layers_dropped"]["series"][0]["value"] == (5 if max_layers == 3 else 0)


def test_audit_model_metrics_and_trace_instants_equal_jax():
    treg, jreg = MetricsRegistry(), JaxRegistry()
    ttr, jtr = Tracer(clock=FakeClock(tick=0.001)), JaxTracer(clock=JaxFakeClock(tick=0.001))
    num.audit_model(_golden_params(), QuantPolicy.packed("razer"), metrics=treg, tracer=ttr)
    jax_num.audit_model(_golden_params(as_jax=True), JaxPolicy.packed("razer"), metrics=jreg, tracer=jtr)
    assert treg.snapshot() == jreg.snapshot()
    instants = [e for e in ttr.to_json()["traceEvents"] if e.get("ph") == "i" and e["name"] == "quant_audit"]
    assert {e["args"]["layer"] for e in instants} == {"blk/attn/wq", "mlp/experts/w_in"}
    assert [e for e in ttr.to_json()["traceEvents"] if e.get("ph") == "i"] == \
        [e for e in jtr.to_json()["traceEvents"] if e.get("ph") == "i"]
