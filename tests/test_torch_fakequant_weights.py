"""The port's ``fakequant_model_weights`` and the baseline formats at model
scale against the JAX package on the CPU, on the JAX package's reduced
weights (``_torch_serve_cases``): the fake-quantized tree equals the
reference's leaf for leaf, bit for bit, after ``bridge`` (a ``layers_<g>``
group quantizes as the reference's stacked leaf, under one tensor scale);
the quantization report of a fakequant engine under each baseline
equals the reference's audit (floats within 1e-7 relative); and the
serve launcher's ``--dry`` prints the reference launcher's token stream."""
import dataclasses
import functools
import re

import jax
import numpy as np
import pytest
import torch

from _torch_obs_cases import assert_reports_match, jax_params, port_params
from _torch_serve_cases import configs
from repro.core.policy import LayerRule as JaxRule
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.obs.numerics import audit_model as jax_audit_model
from repro.serving.engine import fakequant_model_weights as jax_fakequant
from repro_torch.bridge import params_from_numpy
from repro_torch.core.policy import LayerRule, QuantPolicy
from repro_torch.obs.numerics import validate_report
from repro_torch.serving.engine import Engine, ServeConfig, fakequant_model_weights

torch.set_num_threads(2)

ARCHS = ("llama3_2_3b", "dbrx")
OVERRIDES = dict(mlp=dict(special_values=(5.0, -5.0, 7.0, -7.0)), wq=dict(format="mxfp4"))


def _policies(name):
    """(JAX policy, port policy) by name: a fakequant format, or razer with
    two per-layer overrides (other SV pairs on the MLP, mxfp4 on wq)."""
    if name != "override":
        return JaxPolicy.fakequant(name), QuantPolicy.fakequant(name)
    rules = [("*mlp*", OVERRIDES["mlp"]), ("*wq*", OVERRIDES["wq"])]
    return (JaxPolicy.fakequant("razer").with_rules(*(JaxRule.override(p, **kw) for p, kw in rules)),
            QuantPolicy.fakequant("razer").with_rules(*(LayerRule.override(p, **kw) for p, kw in rules)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("policy", ["razer", "nvfp4", "mxfp4", "override"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fakequant_model_weights_equal_reference_leaf_for_leaf(arch, policy):
    jpol, tpol = _policies(policy)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_fakequant(jax_params(arch), None, jpol)),
                             device="cpu")
    raw = port_params(arch)
    got = fakequant_model_weights(raw, None, tpol)
    want_leaves, got_leaves = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    raw_leaves = dict(_leaves(raw))
    changed = set()
    for (path, w), (_, g) in zip(want_leaves, got_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w), path
        if not torch.equal(g, raw_leaves[path]):
            changed.add(re.sub(r"\[\d+\]", "", path))
    # every layer's attention linears, and the dense MLP's; never an
    # expert bank (banks fake-quantize at forward time), embed or norm
    assert {f"/layers_0/mixer/{n}" for n in ("wq", "wk", "wv", "wo")} <= changed
    assert not any(k in p for p in changed for k in ("experts", "embed", "norm", "router"))


@functools.lru_cache(maxsize=None)
def _jax_report(arch, name):
    return jax_audit_model(jax_params(arch), JaxPolicy.fakequant(name), model=arch)


@pytest.mark.parametrize("name", ["mxfp4", "int4", "nf4", "fouroversix"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fakequant_engine_quant_report_equals_reference(arch, name):
    _, tcfg = configs(arch)
    eng = Engine(port_params(arch), tcfg, ServeConfig(max_len=32, quant=QuantPolicy.fakequant(name)), device="cpu")
    got = eng.quant_audit(model=arch)
    want = _jax_report(arch, name)
    assert [l["path"] for l in got["layers"]] == [l["path"] for l in want["layers"]]
    assert_reports_match(want, got)
    assert validate_report(got) == [] and got["rollups"]["max_drift"] == 0.0
    assert all(l["format"] == name and l["mode"] == "fakequant" and "sv" not in l for l in got["layers"])


class _Reduced32:
    """A config whose ``reduced()`` computes in float32 (both packages)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return dataclasses.replace(self.cfg.reduced(), compute_dtype="float32")


def test_dry_serve_prints_the_reference_launchers_token_stream(monkeypatch, capsys):
    from repro.configs import get_config as jax_get_config
    from repro.launch import serve as jax_serve
    from repro.models import transformer as jax_tf
    from repro.serving.engine import Engine as JaxEngine
    from repro_torch import configs as torch_configs
    from repro_torch.launch import serve as torch_serve
    from repro_torch.models import transformer as torch_tf

    monkeypatch.setattr(jax_serve, "get_config", lambda name: _Reduced32(jax_get_config(name)))
    real_get = torch_configs.get_config
    monkeypatch.setattr(torch_configs, "get_config", lambda name: _Reduced32(real_get(name)))
    jax_outputs = []
    jax_generate = JaxEngine.generate

    def recording_generate(self, reqs, *a, **kw):
        out = jax_generate(self, reqs, *a, **kw)
        jax_outputs.extend(list(o[len(r):]) for o, r in zip(out, reqs))
        jax_outputs.append(self.scfg.max_len)
        return out

    monkeypatch.setattr(JaxEngine, "generate", recording_generate)

    def bridged_init(cfg, seed=0, device="cuda"):
        jcfg = dataclasses.replace(jax_get_config("llama3_2_3b").reduced(), compute_dtype="float32")
        tree = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device=device)

    monkeypatch.setattr(torch_tf, "init_params", bridged_init)
    flags = ["--dry", "--packed", "--kv-quant", "--requests", "9", "--max-new", "12", "--max-len", "256"]
    capsys.readouterr()
    jax_serve.main(["--arch", "llama3_2_3b", *flags])
    jax_lines = re.findall(r"^  prompt\[\d+\] -> .*$", capsys.readouterr().out, re.M)
    got = torch_serve.main(["--arch", "llama3_2_3b", "--device", "cpu", *flags])
    torch_lines = re.findall(r"^  prompt\[\d+\] -> .*$", capsys.readouterr().out, re.M)
    assert jax_outputs[-1] == 64 and len(jax_outputs) == 5  # 4 requests, max_len 64
    assert [list(o) for o in got] == jax_outputs[:-1] and all(len(o) == 4 for o in got)
    assert torch_lines == jax_lines and len(torch_lines) == 3
