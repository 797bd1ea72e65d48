"""The port's two hard rules: it never imports JAX or the JAX package, and it
never runs on the CPU unless asked to, nor falls back from a kernel to its
plain version for a CUDA tensor."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    """In a fresh interpreter (this one has JAX loaded by conftest), import
    every module of repro_torch and check what came with them."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20  # every submodule was imported


def test_port_sources_do_not_name_jax_or_repro():
    for path in list((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: {line}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks what happens on a machine without CUDA")


def test_entry_points_refuse_to_run_silently_on_cpu(no_cuda):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = get_config("llama3_2_3b").reduced()
    params = init_params(cfg, device="cpu")
    for call in (lambda: Engine(params, cfg, ServeConfig()),
                 lambda: init_params(cfg),
                 lambda: params_from_numpy({})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cuda_wrappers_reject_cpu_tensors():
    """A kernel wrapper handed CPU tensors raises; only ``ops`` routes CPU
    tensors to the plain versions."""
    from repro_torch.kernels.razer_grouped_matmul import razer_grouped_matmul_cuda
    from repro_torch.kernels.razer_kv_attention import razer_kv_attention_cuda
    from repro_torch.kernels.razer_matmul import razer_matmul_cuda
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    u8 = lambda *s: torch.zeros(s, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        razer_matmul_cuda(torch.zeros(4, 64), u8(32, 64), u8(4, 64), m0=5.0, m1=8.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        razer_grouped_matmul_cuda(torch.zeros(2, 4, 64), u8(2, 32, 64), u8(2, 4, 64), m0=5.0, m1=8.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        razer_act_qdq_cuda(torch.zeros(4, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        razer_kv_attention_cuda(torch.zeros(1, 2, 32), u8(1, 8, 1, 16), u8(1, 8, 1, 2),
                                u8(1, 8, 1, 16), u8(1, 8, 1, 2), torch.ones(1, dtype=torch.int32))


def test_ops_has_no_fallback_from_kernel_to_plain():
    """For a CUDA tensor, ops calls the kernel wrapper with no try/except
    around it, so a failed build or launch raises."""
    src = (REPO / "src" / "repro_torch" / "kernels" / "ops.py").read_text()
    assert "try:" not in src and "except" not in src


@pytest.mark.parametrize("module", ["models/moe.py", "kernels/razer_grouped_matmul.py"])
def test_moe_path_has_no_fallback_from_kernel_to_plain(module):
    """The MoE layer reaches the grouped kernel through the registry and ops,
    and the kernel's wrapper launches it, with no try/except on the way."""
    src = (REPO / "src" / "repro_torch" / module).read_text()
    assert "try:" not in src and "except" not in src


_IMPORT_TRAIN = """
import importlib, sys
for name in ("repro_torch.train.optimizer", "repro_torch.train.data", "repro_torch.train.trainstep",
             "repro_torch.train.checkpoint", "repro_torch.train.fault", "repro_torch.launch.train",
             "repro_torch.launch.costmodel", "repro_torch.models.inputs", "repro_torch.kernels.prefill_attention_bwd",
             "repro_torch.kernels.rms_norm_bwd"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
assert not bad, bad
"""


def test_training_modules_import_no_jax():
    """The training slice (``train/``, its launchers, the input specs and the
    backward kernels' wrappers) on its own, in a fresh interpreter."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN], capture_output=True, text=True,
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_backward_wrappers_reject_cpu_tensors_and_train_refuses_the_cpu(no_cuda):
    """The backward kernels' wrappers take CUDA tensors only (on the CPU
    autograd runs through the plain versions), and the train launcher runs
    on the card unless asked for the CPU."""
    from repro_torch.kernels.prefill_attention_bwd import prefill_attention_bwd_cuda
    from repro_torch.kernels.rms_norm_bwd import rms_norm_bwd_cuda
    from repro_torch.launch import train

    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        prefill_attention_bwd_cuda(q, q[:, :, :1], q[:, :, :1], q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms_norm_bwd_cuda(torch.zeros(2, 8), torch.zeros(8), torch.zeros(2, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "llama3_2_3b", "--reduced", "--steps", "1"])
