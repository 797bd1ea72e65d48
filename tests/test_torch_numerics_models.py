"""The port's quantization audit of reduced models against the JAX
package's, on the JAX package's weights: reduced ``llama3_2_3b`` (scan
groups the port keeps as per-layer lists) and reduced ``dbrx_132b`` (expert
banks: ``entries`` L x E), under the packed W4 policy and under razer and
nvfp4 fakequant (the generic audit).  The reports must have the same layer
paths in the same order, containers, shapes, ``entries``, histograms and
integer rollups, floats within 1e-7 relative, a valid schema and a drift of
exactly 0; ``Engine.quant_audit`` must report what ``audit_model`` does on
the tree it serves from."""
import functools

import pytest

from _torch_obs_cases import assert_reports_match, jax_params, port_params
from _torch_serve_cases import port_engine
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.obs.numerics import audit_model as jax_audit_model
from repro_torch.core.policy import QuantPolicy
from repro_torch.obs.numerics import audit_model, validate_report

POLICIES = {
    "packed": (lambda: JaxPolicy.packed(kv_quant=True), lambda: QuantPolicy.packed(kv_quant=True)),
    "fakequant_razer": (lambda: JaxPolicy.fakequant("razer"), lambda: QuantPolicy.fakequant("razer")),
    "fakequant_nvfp4": (lambda: JaxPolicy.fakequant("nvfp4"), lambda: QuantPolicy.fakequant("nvfp4")),
}


@functools.lru_cache(maxsize=None)
def _jax_report(arch, policy):
    return jax_audit_model(jax_params(arch), POLICIES[policy][0](), model=arch)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ["llama3_2_3b", "dbrx"])
def test_reduced_model_report_equals_jax(arch, policy):
    want = _jax_report(arch, policy)
    got = audit_model(port_params(arch), POLICIES[policy][1](), model=arch)
    assert [l["path"] for l in got["layers"]] == [l["path"] for l in want["layers"]]
    assert_reports_match(want, got)
    assert validate_report(got) == []
    assert got["rollups"]["max_drift"] == 0.0
    if policy == "packed":
        containers = {l["container"] for l in got["layers"]}
        assert containers == ({"PackedRazerWeight", "PackedStackedTensor"} if arch == "dbrx"
                              else {"PackedRazerWeight"})
        for layer in got["layers"]:
            lead = layer["shape"][0] * (layer["shape"][1] if layer["container"] == "PackedStackedTensor" else 1)
            assert layer["entries"] == lead and layer["sv"]["block_rate"] > 0


def test_engine_quant_audit_reports_the_served_tree():
    eng = port_engine("w4_kv")
    rep = eng.quant_audit(model="llama3_2_3b")
    assert rep == audit_model(eng._raw_params, eng.policy, model="llama3_2_3b")
    assert_reports_match(_jax_report("llama3_2_3b", "packed"), rep)
    assert rep["rollups"]["layers_audited"] == 7 and rep["rollups"]["max_drift"] == 0.0
