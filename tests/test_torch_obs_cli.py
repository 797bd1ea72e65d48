"""The port's observability command lines on the CPU: ``python -m
repro_torch.launch.quant_report`` (its report passes ``tools/check_bench.py
--report``), the serve launcher's ``--metrics-out``, ``--quant-report``,
``--kv-audit``, ``--trace-out`` and ``--torch-profile`` (valid files, the
reference's argument checks), and its ``--prefill-budget`` /
``--shared-prefix`` traffic, whose token stream must equal the JAX
launcher's for the same flags (both on float32 reduced configs, the port on
the JAX package's weights)."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro_torch.launch import quant_report
from repro_torch.launch import serve as torch_serve
from repro_torch.obs.numerics import validate_report

REPO = Path(__file__).resolve().parents[1]
CPU = ["--reduced", "--device", "cpu"]


def _tool(name, *args):
    """Run a repo tool (``tools/*.py``) in a subprocess -> (exit code, output)."""
    out = subprocess.run([sys.executable, str(REPO / "tools" / f"{name}.py"), *map(str, args)],
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout + out.stderr


def test_quant_report_dry_passes_check_bench(tmp_path, capsys):
    out, metrics, trace = tmp_path / "r.json", tmp_path / "m.json", tmp_path / "t.json"
    assert quant_report.main(["--arch", "llama3_2_3b", "--dry", "--device", "cpu", "--out", str(out),
                              "--metrics-out", str(metrics), "--trace-out", str(trace)]) == 0
    report = json.loads(out.read_text())
    assert validate_report(report) == [] and report["rollups"]["max_drift"] == 0.0
    assert out.read_text() == json.dumps(report, indent=1, sort_keys=True) + "\n"
    assert json.loads(metrics.read_text())["quant_model_drift_max"]["series"][0]["value"] == 0.0
    assert _tool("check_bench", "--report", out)[0] == 0
    assert _tool("check_trace", trace)[0] == 0
    assert "layers audited" in capsys.readouterr().out


def test_quant_report_fakequant_nvfp4_and_refusals(tmp_path):
    out = tmp_path / "n.json"
    assert quant_report.main(["--arch", "llama3_2_3b", "--dry", "--device", "cpu", "--format", "nvfp4",
                              "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["policy"]["mode"] == "fakequant" and report["rollups"]["max_drift"] == 0.0
    assert all("sv" not in layer for layer in report["layers"])
    for argv in (["--format", "nvfp4", "--mode", "packed"], ["--format", "mxfp9"]):
        with pytest.raises(SystemExit):
            quant_report.main(["--arch", "llama3_2_3b", "--dry", "--device", "cpu", *argv])


def test_serve_launcher_writes_observability_files(tmp_path):
    q, m, t, prof = tmp_path / "q.json", tmp_path / "m.json", tmp_path / "t.json", tmp_path / "prof"
    outputs = torch_serve.main(["--arch", "llama3_2_3b", *CPU, "--packed", "--kv-quant", "--continuous",
                                "--requests", "3", "--max-new", "3", "--shared-prefix", "16",
                                "--metrics-out", str(m), "--quant-report", str(q), "--kv-audit", "1",
                                "--trace-out", str(t), "--torch-profile", str(prof)])
    report = json.loads(q.read_text())
    assert validate_report(report) == [] and report["rollups"]["max_drift"] == 0.0
    assert report["kv"]["prefills_seen"] == 3 and report["kv"]["pages_sampled"] > 0
    assert _tool("check_bench", "--report", q)[0] == 0
    snap = json.loads(m.read_text())
    assert snap["serve_tokens_total"]["series"][0]["value"] == sum(len(o) for o in outputs) == 9
    assert snap["cache_hits"]["series"][0]["value"] >= 1  # the shared system prompt
    assert _tool("check_trace", t)[0] == 0
    assert "traceEvents" in json.loads((prof / "serve_trace.json").read_text())
    prom = tmp_path / "m.prom"
    torch_serve.main(["--arch", "llama3_2_3b", *CPU, "--packed", "--disagg", "--requests", "3", "--max-new", "2",
                      "--prefill-replicas", "2", "--decode-replicas", "2", "--metrics-out", str(prom)])
    text = prom.read_text()
    assert text.startswith("# HELP") and 'pool_pages{stage="decode",replica="1",state="free"}' in text
    assert "disagg_shipments_total 3" in text


@pytest.mark.parametrize("argv", [
    ["--quant-report", "q.json", "--continuous"],  # no --packed: no wire bytes to audit
    ["--packed", "--quant-report", "q.json", "--kv-audit", "1"],  # --kv-audit without --continuous
    ["--packed", "--continuous", "--kv-audit", "1"],  # --kv-audit without --quant-report
    ["--metrics-out", "m.json"],  # a serving-loop metric without --continuous / --disagg
    ["--torch-profile", "prof", "--disagg"],  # the profiler brackets the single-engine loop
    ["--speculate-k", "2", "--disagg"],
])
def test_serve_launcher_argument_checks(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        torch_serve.main(["--arch", "llama3_2_3b", *CPU, *argv])
    assert e.value.code == 2
    assert not list(tmp_path.iterdir())  # refused before anything was written


class _Reduced32:
    """A config whose ``reduced()`` computes in float32 (both packages)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self):
        return dataclasses.replace(self.cfg.reduced(), compute_dtype="float32")


def test_prefill_budget_and_shared_prefix_token_stream_equals_jax_launcher(monkeypatch):
    from repro.configs import get_config as jax_get_config
    from repro.launch import serve as jax_serve
    from repro.models import transformer as jax_tf
    from repro.serving.engine import Engine as JaxEngine
    from repro_torch import configs as torch_configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import transformer as torch_tf

    monkeypatch.setattr(jax_serve, "get_config", lambda name: _Reduced32(jax_get_config(name)))
    real_get = torch_configs.get_config
    monkeypatch.setattr(torch_configs, "get_config", lambda name: _Reduced32(real_get(name)))
    jax_outputs = []
    jax_engine_serve = JaxEngine.serve

    def recording_serve(self, *a, **kw):
        rep = jax_engine_serve(self, *a, **kw)
        jax_outputs.extend(list(r.out_tokens) for r in rep.requests)
        return rep

    monkeypatch.setattr(JaxEngine, "serve", recording_serve)

    def bridged_init(cfg, seed=0, device="cuda"):
        jcfg = dataclasses.replace(jax_get_config("llama3_2_3b").reduced(), compute_dtype="float32")
        tree = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device=device)

    monkeypatch.setattr(torch_tf, "init_params", bridged_init)
    flags = ["--packed", "--kv-quant", "--continuous", "--requests", "5", "--max-new", "4", "--slots", "2",
             "--max-len", "64", "--shared-prefix", "20", "--prefill-budget", "24"]
    jax_serve.main(["--arch", "llama3_2_3b", "--reduced", *flags])
    got = torch_serve.main(["--arch", "llama3_2_3b", "--reduced", "--device", "cpu", *flags])
    assert len(jax_outputs) == 5 and [list(o) for o in got] == jax_outputs
