"""The numerics audit and the KV audit on a card: the golden report byte for
byte, the packed-vs-fakequant drift exactly 0, the card's audit of the same
tensors equal to the CPU's, ``pack_weight``'s, the §5.1 baselines' and
GPTQ's results on the card equal to the CPU's, and serve's tokens
bit-identical with the KV-audit hook on and off.

Every test here is marked ``cuda`` and skips without a GPU; the file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_obs.py
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.packing import pack_weight
from repro_torch.core.policy import QuantPolicy
from repro_torch.obs import KVAuditor, MetricsRegistry
from repro_torch.obs.numerics import audit_model, razer_audit

GOLDEN = Path(__file__).parent / "data" / "quant_report_golden.json"
_BLOCK_A = [0, 1, 2, 3, 4, 6, -1, -2, -3, -4, -6, 0.5, 1.5, -0.5, -1.5, 5.0]
_BLOCK_B = _BLOCK_A[:-1] + [5.25]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the CPU the plain versions are tested")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_golden_report_byte_for_byte(cuda_device):
    w = torch.stack([torch.tensor(_BLOCK_A if i % 2 == 0 else _BLOCK_B) for i in range(16)], dim=1).to(cuda_device)
    params = {"embed": {"w": torch.zeros(4, 4, device=cuda_device)}, "blk": {"attn": {"wq": w}},
              "mlp": {"experts": {"w_in": torch.stack([w, w])}}}
    rep = audit_model(params, QuantPolicy.packed("razer"), model="micro")
    assert json.dumps(rep, indent=1, sort_keys=True) + "\n" == GOLDEN.read_text()


@pytest.mark.cuda
def test_cuda_pack_weight_bytes_equal_cpu(cuda_device):
    """The same float32 weights packed on the card and on the CPU give the
    same tensor scale, codes and scale/meta bytes."""
    for seed, shape in enumerate([(512, 384), (4096, 1024), (14336, 256)]):
        w = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 0.02
        card, cpu = pack_weight(w.to(cuda_device)), pack_weight(w)
        assert torch.equal(card.tensor_scale.cpu(), cpu.tensor_scale), shape
        assert torch.equal(card.codes.cpu(), cpu.codes) and torch.equal(card.scale_meta.cpu(), cpu.scale_meta)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mxfp4_quantize", "int4_quantize", "nf4_quantize", "fouroversix_quantize"])
def test_cuda_baseline_quantize_bytes_equal_cpu(cuda_device, name):
    """The §5.1 baselines on a (14336, 4096) float32 weight blocked along
    d_in, seeds 0-2: the card's q, block scales and tensor scale equal the
    CPU's bit for bit (no division by a Python number, ROADMAP C.5)."""
    from repro_torch.core import baselines

    fn = getattr(baselines, name)
    for seed in range(3):
        w = torch.randn((14336, 4096), generator=torch.Generator().manual_seed(seed)) * 0.02
        card, cpu = fn(w.to(cuda_device), axis=0), fn(w, axis=0)
        for field in ("q", "block_scale", "tensor_scale"):
            a, b = getattr(card, field).cpu(), getattr(cpu, field)
            assert a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32)), (seed, field)


@pytest.mark.cuda
@pytest.mark.parametrize("group_size,block_size", [(16, 128), (128, 64)])
@pytest.mark.parametrize("fmt", ["razer", "int4"])
def test_cuda_gptq_equals_cpu(cuda_device, fmt, group_size, block_size):
    """GPTQ of a (512, 256) weight on 512 correlated calibration rows (seed
    7, as ``tests/test_torch_gptq.py`` draws them) under the RaZeR and INT4
    group quantizers: the card's dequantized weight equals the CPU's bit for
    bit, though the card factors the Hessian and sums the updates in its own
    order (GPTQ carries any flipped code into every later row)."""
    from repro_torch.core.baselines import int4_quantize
    from repro_torch.core.gptq import gptq_quantize, make_group_quantizer
    from repro_torch.core.razer import razer_quantize

    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.standard_t(5, size=(512, 256)) * 0.02).astype(np.float32))
    x = rng.standard_normal((512, 512)).astype(np.float32)
    x[:, 1:] += 0.5 * x[:, :-1]  # correlated input channels
    x = torch.from_numpy(x)
    if fmt == "razer":
        factory = make_group_quantizer(lambda g: razer_quantize(g, axis=0, scale_fmt="e3m3"))
    else:
        factory = make_group_quantizer(lambda g: int4_quantize(g, axis=0, block_size=group_size))
    kw = dict(group_size=group_size, block_size=block_size)
    card = gptq_quantize(w.to(cuda_device), x.to(cuda_device), factory, device=cuda_device, **kw).cpu()
    cpu = gptq_quantize(w, x, factory, device="cpu", **kw)
    ref = x @ w
    mse = [float(((x @ q - ref) ** 2).mean()) for q in (card, cpu)]
    n_diff = int((card != cpu).sum())
    assert n_diff == 0, (n_diff, mse)


@pytest.mark.cuda
def test_cuda_drift_exactly_zero_and_card_equals_cpu(cuda_device):
    """Gathered over three layers of (512, 384) bf16 weights packed on the
    card: drift 0 there; the same containers and weights moved to the CPU
    audit to equal integer fields and floats within 1e-7 relative."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ws = [torch.randn((512, 384), generator=g, device=cuda_device).to(torch.bfloat16) for _ in range(3)]
    spec = QuantPolicy.packed("razer").weight
    packed = [pack_weight(w.float()) for w in ws]
    card = razer_audit(packed, ws, spec)
    cpu = razer_audit([p.to("cpu") for p in packed], [w.cpu() for w in ws], spec)
    assert card["drift_max_abs"] == 0.0 == cpu["drift_max_abs"]
    for key in ("entries", "n_blocks", "wire_bytes", "code_hist", "scale"):
        assert card[key] == cpu[key], key
    assert {k: v for k, v in card["sv"].items() if "rate" not in k} == \
        {k: v for k, v in cpu["sv"].items() if "rate" not in k}
    for key in ("sqnr_db", "mse", "max_abs_err"):
        assert abs(card[key] - cpu[key]) <= 1e-7 * abs(cpu[key]), key


@pytest.mark.cuda
def test_cuda_kv_audit_leaves_serve_tokens_bit_identical(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig

    cfg = get_config("llama3_2_3b").reduced()
    eng = Engine(init_params(cfg, seed=0, device=cuda_device), cfg,
                 ServeConfig(max_len=64, max_new_tokens=4, quant=QuantPolicy.packed(kv_quant=True)),
                 device=cuda_device)
    prompts = [[5 + i, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21][: 5 + 6 * i] for i in range(3)]
    base = eng.serve(prompts)
    auditor, reg = KVAuditor(sample_every=1), MetricsRegistry()
    audited = eng.serve(prompts, kv_audit=auditor, metrics=reg)
    assert audited.outputs == base.outputs
    snap = auditor.snapshot()
    assert snap["prefills_seen"] == 3 and snap["pages_sampled"] > 0 and snap["sqnr_db"] > 0
    assert snap["tokens_sampled"] == sum(len(p) for p in prompts)
    assert reg.snapshot()["serve_decode_step_seconds"]["series"][0]["count"] == audited.decode_steps
