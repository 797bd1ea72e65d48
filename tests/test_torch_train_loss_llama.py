"""``lm_loss`` and every leaf of its gradient on reduced llama3_2_3b (the dense GQA stack):
the port against ``jax.value_and_grad(repro.models.transformer.lm_loss)``,
f32 compute, from the same weights and tokens, under bf16 weights,
weight-only QAT and W4A4 QAT with the straight-through estimator
(``_torch_train_cases.run_loss_case``), and W4A4 without it (on the CPU
both differentiate the activation quantizer's own ops; the card refuses
that case, ``tests/test_torch_cuda_train.py``).

Tolerances: the loss within 1e-5 relative, each gradient leaf within 1e-4
of its largest magnitude (f32 sums in other orders through the layers and
the backward), and the same nonzero positions in every leaf: under QAT the
reference's weight gradients are sparse (ROADMAP caveat 10: its weight
fake-quant has no straight-through estimator, so a gradient reaches only
the elements that set a block's scale), and the port's are sparse alike.
"""
import pytest

from _torch_train_cases import NO_STE, POLICIES, run_loss_case

ARCH = "llama3_2_3b"


@pytest.mark.parametrize("policy", list(POLICIES) + list(NO_STE))
def test_lm_loss_and_grads_equal_the_reference(policy):
    grads = run_loss_case(ARCH, policy)
    nonzero = float((grads["layers_0"][0]["mixer"]["wq"] != 0).float().mean())
    if policy == "bf16":
        assert nonzero > 0.99
    else:  # caveat 10: the weight qdq passes a gradient only through its block scales
        assert nonzero < 0.05
