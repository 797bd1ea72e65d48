"""Training on a card: the backward kernels of K9 (prefill attention) and K10
(RMSNorm) against autograd through their plain versions, the routing of
``kernels.ops`` (a forward that wants a gradient runs the kernel and its
backward kernel; K2 refuses a gradient), and a reduced train step on the
card against the same step on the CPU.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_train.py

Tolerances, against max |want| of each gradient (``_close``): f32 inputs
1e-4 (f32 sums in another order over up to a few thousand terms); bf16
inputs 2^-6 (the outputs are bf16, and autograd through the plain version
rounds P and dP to bf16 on their way, where the kernel keeps them f32).
"""
import dataclasses

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention_bwd as pab
from repro_torch.kernels import rms_norm_bwd as rnb
from repro_torch.kernels.prefill_attention import prefill_attention_cuda
from repro_torch.kernels.rms_norm import rms_norm_cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the CPU the plain versions are tested")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype, what=""):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= TOL[dtype] * max(scale, 1e-30), (what, err, scale)
    return err / max(scale, 1e-30)


def _attention_inputs(dev, b, sq, skv, h, kvh, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, skv, kvh, hd), generator=g, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 77, 77, 4, 2, 16), (1, 130, 130, 8, 8, 32), (2, 64, 64, 6, 2, 64),
                                   (1, 200, 200, 24, 8, 128)], ids=lambda s: "x".join(map(str, s)))
def test_attention_bwd_matches_plain_autograd(cuda_device, dtype, shape):
    b, sq, skv, h, kvh, hd = shape
    q, k, v, dout = _attention_inputs(cuda_device, b, sq, skv, h, kvh, hd, dtype)
    o = prefill_attention_cuda(q, k, v)
    got = pab.prefill_attention_bwd_cuda(q, k, v, o, dout)
    want = pab.plain(q, k, v, dout)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
        assert gt.dtype == wt.dtype == dtype
        _close(gt, wt, dtype, name)
    again = pab.prefill_attention_bwd_cuda(q, k, v, o, dout)
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "the backward's bits do not repeat"


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [dict(causal=False), dict(window=24), dict(q_offset=40)],
                         ids=["noncausal", "window", "q_offset"])
def test_attention_bwd_masks(cuda_device, mask):
    skv = 150 if "q_offset" in mask else 110
    q, k, v, dout = _attention_inputs(cuda_device, 2, 110, skv, 4, 2, 32, torch.float32, seed=1)
    o = prefill_attention_cuda(q, k, v, **mask)
    for name, gt, wt in zip(("dq", "dk", "dv"), pab.prefill_attention_bwd_cuda(q, k, v, o, dout, **mask),
                            pab.plain(q, k, v, dout, **mask)):
        _close(gt, wt, torch.float32, name)


@pytest.mark.cuda
def test_attention_bwd_refuses_other_widths(cuda_device):
    q, k, v, _ = _attention_inputs(cuda_device, 1, 8, 8, 2, 1, 256, torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        ops.prefill_attention(q.requires_grad_(True), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows_d", [(4, 3072), (300, 512), (4096, 128)], ids=lambda s: "x".join(map(str, s)))
def test_rms_norm_bwd_matches_plain_autograd(cuda_device, dtype, rows_d):
    rows, d = rows_d
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn((rows, d), generator=g, device=cuda_device) * 3).to(dtype)
    gamma = torch.randn(d, generator=g, device=cuda_device) * 0.1
    dy = torch.randn((rows, d), generator=g, device=cuda_device).to(dtype)
    dx, dgamma = rnb.rms_norm_bwd_cuda(x, gamma, dy, 1e-5)
    want_dx, want_dgamma = rnb.plain(x, gamma, dy, 1e-5)
    _close(dx, want_dx, dtype, "dx")
    _close(dgamma, want_dgamma, torch.float32 if dtype == torch.float32 else dtype, "dgamma")
    again = rnb.rms_norm_bwd_cuda(x, gamma, dy, 1e-5)
    assert torch.equal(dx, again[0]) and torch.equal(dgamma, again[1])


@pytest.mark.cuda
def test_ops_route_gradients_through_the_backward_kernels(cuda_device):
    q, k, v, dout = _attention_inputs(cuda_device, 1, 40, 40, 4, 2, 16, torch.bfloat16)
    x = torch.randn((3, 40, 64), device=cuda_device).to(torch.bfloat16)
    gamma = torch.zeros(64, device=cuda_device)
    counts = [f.launches for f in (prefill_attention_cuda, pab.prefill_attention_bwd_cuda, rms_norm_cuda,
                                   rnb.rms_norm_bwd_cuda)]
    q.requires_grad_(True)
    x.requires_grad_(True)
    gamma.requires_grad_(True)
    (ops.prefill_attention(q, k, v).float() * dout.float()).sum().backward()
    ops.rms_norm(x, gamma).float().sum().backward()
    after = [f.launches for f in (prefill_attention_cuda, pab.prefill_attention_bwd_cuda, rms_norm_cuda,
                                  rnb.rms_norm_bwd_cuda)]
    assert [a - c for a, c in zip(after, counts)] == [1, 1, 1, 1]
    assert q.grad is not None and x.grad is not None and gamma.grad is not None
    with torch.no_grad():  # no gradient asked for: the forward kernels alone, as serving runs them
        ops.prefill_attention(q, k, v)
    assert pab.prefill_attention_bwd_cuda.launches == after[1]


@pytest.mark.cuda
def test_k2_refuses_a_gradient_and_ste_passes_it(cuda_device):
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.qlinear import qlinear
    from repro_torch.kernels.razer_quantize import razer_act_qdq_cuda

    x = torch.randn((4, 64), device=cuda_device, requires_grad=True)
    w = torch.randn((64, 32), device=cuda_device) * 0.1
    with pytest.raises(ValueError, match="no backward"):
        qlinear(x, w, QuantPolicy.fakequant(act_format="razer"))
    n = razer_act_qdq_cuda.launches
    y = qlinear(x, w, QuantPolicy.fakequant(act_format="razer", ste=True))
    assert razer_act_qdq_cuda.launches == n + 1
    y.sum().backward()
    wq = QuantPolicy.fakequant().weight.qdq(w, axis=0)
    torch.testing.assert_close(x.grad, wq.sum(dim=1).expand(4, 64), rtol=1e-6, atol=1e-6)  # straight through


def _train(cfg, device, params, steps, lr):
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step

    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2))
    step = make_train_step(cfg, None, AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps))
    opt, losses = init_opt_state(params), []
    for i in range(steps):
        batch = {k: torch.from_numpy(a).to(device) for k, a in ds.batch(i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.cuda
def test_reduced_train_steps_card_equal_cpu(cuda_device):
    """Reduced llama3_2_3b in f32, 3 steps from the same init: losses within
    1e-5 relative; parameters within 4 x the summed learning rate (an element
    whose gradient is near 0 can flip its Adam update's sign, about 2 lr a
    step), and all but 0.1 % of them within 1e-6."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), compute_dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    lr, steps = 1e-4, 3
    cpu, cpu_losses = _train(cfg, torch.device("cpu"), cpu, steps, lr)
    card, card_losses = _train(cfg, cuda_device, card, steps, lr)
    for a, c in zip(card_losses, cpu_losses):
        assert abs(a - c) <= 1e-5 * abs(c), (card_losses, cpu_losses)
    diffs = torch.cat([(a.cpu() - c).abs().flatten() for a, c in zip(tree_leaves(card), tree_leaves(cpu))])
    assert float(diffs.max()) <= 4 * steps * lr
    assert float((diffs > 1e-6).float().mean()) <= 1e-3
