"""Training on a card: the backward kernels of K9 (prefill attention) and K10
(RMSNorm) against autograd through their plain versions, K9's at MLA's
(192, 128) and RecurrentGemma's (256, 256) widths too, the routing of
``kernels.ops`` (a forward that wants a gradient runs the kernel and its
backward kernel; K2 refuses a gradient), and reduced train steps (llama,
MLA at its real head widths, RecurrentGemma at head width 256) on the card
against the same steps on the CPU.

Every test here is marked ``cuda`` and skips without a GPU.  The file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_train.py

Tolerances, against max |want| of each gradient (``_close``): f32 inputs
1e-4 (f32 sums in another order over up to a few thousand terms; K9's
backward runs its f32 body on the CUDA cores); bf16 inputs 2^-6 (the
outputs are bf16; K9's backward runs its tensor-core body, which rounds P
and dS to bf16 as the operands of its products, where autograd through the
plain version rounds P and dP on their way).
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


def _attention_inputs(dev, b, sq, skv, h, kvh, hd, dtype, seed=0, dv=None):
    """q, k (B, S, heads, hd); v and dout at V's width ``dv`` (hd)."""
    dv = dv or hd
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, skv, kvh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, skv, kvh, dv), generator=g, device=dev).to(dtype)
    dout = torch.randn((b, sq, h, dv), generator=g, device=dev).to(dtype)
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


MASK_CASES = {  # id -> (mask, (B, Sq, Skv, H, KVH, hd))
    "noncausal": (dict(causal=False), (2, 110, 110, 4, 2, 32)),
    "window": (dict(window=24), (2, 110, 110, 4, 2, 32)),
    "q_offset": (dict(q_offset=40), (2, 110, 150, 4, 2, 32)),
    "window_q_offset_hd128": (dict(window=100, q_offset=60), (1, 150, 230, 6, 2, 128)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(MASK_CASES))
def test_attention_bwd_masks(cuda_device, dtype, case):
    mask, (b, sq, skv, h, kvh, hd) = MASK_CASES[case]
    q, k, v, dout = _attention_inputs(cuda_device, b, sq, skv, h, kvh, hd, dtype, seed=1)
    o = prefill_attention_cuda(q, k, v, **mask)
    got = pab.prefill_attention_bwd_cuda(q, k, v, o, dout, **mask)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, pab.plain(q, k, v, dout, **mask)):
        _close(gt, wt, dtype, name)
    again = pab.prefill_attention_bwd_cuda(q, k, v, o, dout, **mask)
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "the backward's bits do not repeat"


# MLA's widths (q/k 192, V 128) and RecurrentGemma's (256, its window, G
# up to 10): id -> (mask, (B, Sq, Skv, H, KVH, hd, dv))
WIDE_CASES = {
    "mla_causal": (dict(), (1, 150, 150, 4, 4, 192, 128)),
    "mla_noncausal_g2": (dict(causal=False), (2, 100, 100, 4, 2, 192, 128)),
    "mla_window": (dict(window=40), (1, 130, 130, 3, 3, 192, 128)),
    "mla_window_q_offset": (dict(window=50, q_offset=60), (1, 100, 164, 2, 2, 192, 128)),
    "hd256_causal": (dict(), (1, 150, 150, 5, 1, 256, 256)),
    "hd256_window": (dict(window=24), (2, 110, 110, 10, 1, 256, 256)),
    "hd256_window_q_offset": (dict(window=100, q_offset=60), (1, 150, 230, 4, 2, 256, 256)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_attention_bwd_wide_heads(cuda_device, dtype, case):
    mask, (b, sq, skv, h, kvh, hd, dv) = WIDE_CASES[case]
    q, k, v, dout = _attention_inputs(cuda_device, b, sq, skv, h, kvh, hd, dtype, seed=3, dv=dv)
    o = prefill_attention_cuda(q, k, v, **mask)
    got = pab.prefill_attention_bwd_cuda(q, k, v, o, dout, **mask)
    for name, gt, wt in zip(("dq", "dk", "dv"), got, pab.plain(q, k, v, dout, **mask)):
        assert gt.dtype == wt.dtype == dtype and gt.shape == wt.shape, name
        _close(gt, wt, dtype, name)
    again = pab.prefill_attention_bwd_cuda(q, k, v, o, dout, **mask)
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "the backward's bits do not repeat"


@pytest.mark.cuda
def test_attention_bwd_refuses_other_widths(cuda_device):
    q, k, v, _ = _attention_inputs(cuda_device, 1, 8, 8, 2, 1, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        ops.prefill_attention(q.requires_grad_(True), k, v)


@pytest.mark.cuda
def test_ops_train_the_wide_heads_through_the_kernels(cuda_device):
    """With a gradient wanted, ops.prefill_attention runs K9 and its
    backward kernel at MLA's (192, 128) and at (256, 256) with a window."""
    for hd, dv, h, kvh, mask in ((192, 128, 4, 4, {}), (256, 256, 10, 1, dict(window=24))):
        q, k, v, dout = _attention_inputs(cuda_device, 1, 70, 70, h, kvh, hd, torch.bfloat16, seed=4, dv=dv)
        n = (prefill_attention_cuda.launches, pab.prefill_attention_bwd_cuda.launches)
        q.requires_grad_(True)
        out = ops.prefill_attention(q, k, v, **mask)
        assert out.shape == (1, 70, h, dv)
        (out.float() * dout.float()).sum().backward()
        assert (prefill_attention_cuda.launches - n[0], pab.prefill_attention_bwd_cuda.launches - n[1]) == (1, 1)
        _close(q.grad, pab.plain(q.detach(), k, v, dout, **mask)[0], torch.bfloat16, f"dq at hd {hd}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows_d", [(4, 3072), (300, 512), (4096, 128), (4096, 3072), (1000, 1000), (523, 999),
                                    (3, 58112)], ids=lambda s: "x".join(map(str, s)))
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


@pytest.mark.cuda
def test_bf16_step_gradients_kernel_backward_equal_plain_backward(cuda_device, monkeypatch):
    """One reduced bf16 llama3_2_3b step's gradients (2 x 128 tokens), K9's
    backward kernel (its tensor-core body) against the same step with the
    attention's backward routed through autograd of the plain version: each
    leaf within 2^-6 of its max |want|."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import init_params
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.tree import tree_leaves

    cfg = get_config("llama3_2_3b").reduced()
    assert cfg.compute_dtype == "bfloat16"
    params = init_params(cfg, seed=0, device=cuda_device)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2))
    batch = {k: torch.from_numpy(a).to(cuda_device) for k, a in ds.batch(0).items()}

    def grads():
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = tf.lm_loss(params, batch, cfg)
        out = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return out

    n = pab.prefill_attention_bwd_cuda.launches
    got = grads()
    assert pab.prefill_attention_bwd_cuda.launches == n + cfg.num_layers
    monkeypatch.setattr(ops, "prefill_attention_bwd_cuda",
                        lambda q, k, v, o, dout, **mask: pab.plain(q, k, v, dout, **mask))
    want = grads()
    assert pab.prefill_attention_bwd_cuda.launches == n + cfg.num_layers
    for i, (a, w) in enumerate(zip(got, want)):
        _close(a, w, torch.bfloat16, f"leaf {i}")


def _train(cfg, device, params, steps, lr):
    """``steps`` train steps of 2 x 64 tokens of the synthetic data."""
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
    """Reduced llama3_2_3b in f32, 3 steps from the same init (``_card_equal_cpu``)."""
    from repro_torch.configs import get_config

    _card_equal_cpu(get_config("llama3_2_3b").reduced(), cuda_device)


def _card_equal_cpu(cfg, cuda_device):
    """``cfg`` in f32, 3 steps from the same init on the card and the CPU:
    losses within 1e-5 relative; parameters within 4 x the summed learning
    rate (an element whose gradient is near 0 can flip its Adam update's
    sign, about 2 lr a step), and all but 0.1 % of them within 1e-6; the
    card's steps ran K9's backward."""
    from repro_torch.models.transformer import init_params
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    lr, steps = 1e-4, 3
    n = pab.prefill_attention_bwd_cuda.launches
    card, card_losses = _train(cfg, cuda_device, card, steps, lr)
    assert pab.prefill_attention_bwd_cuda.launches > n, "the card's steps ran no K9 backward"
    cpu, cpu_losses = _train(cfg, torch.device("cpu"), cpu, steps, lr)
    for a, c in zip(card_losses, cpu_losses):
        assert abs(a - c) <= 1e-5 * abs(c), (card_losses, cpu_losses)
    diffs = torch.cat([(a.cpu() - c).abs().flatten() for a, c in zip(tree_leaves(card), tree_leaves(cpu))])
    assert float(diffs.max()) <= 4 * steps * lr
    assert float((diffs > 1e-6).float().mean()) <= 1e-3


@pytest.mark.cuda
def test_narrow_mla_train_steps_card_equal_cpu(cuda_device):
    """Reduced deepseek_v2_236b at MLA's real head widths (nope 128, rope
    64, V 128: K9 and its backward at (192, 128)) and its query's low-rank
    path, in f32, 3 steps card against CPU (``_card_equal_cpu``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek_v2_236b").reduced(), qk_nope_dim=128, qk_rope_dim=64,
                              v_head_dim=128, q_lora_rank=32)
    _card_equal_cpu(cfg, cuda_device)


@pytest.mark.cuda
def test_narrow_recurrentgemma_train_steps_card_equal_cpu(cuda_device):
    """Reduced recurrentgemma_2b (r, r, a) at head width 256 with a window
    of 24 (K9 and its backward at (256, 256), the window cutting 64-token
    rows), the RG-LRU scan and conv through autograd, in f32, 3 steps card
    against CPU (``_card_equal_cpu``)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("recurrentgemma_2b").reduced(), head_dim=256, window=24)
    _card_equal_cpu(cfg, cuda_device)
