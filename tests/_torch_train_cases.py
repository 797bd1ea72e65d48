"""Shared setup of the training tests: reduced configs in f32 compute, the
JAX package's parameters carried into the port with ``bridge``, and the
comparison of gradient and parameter trees leaf by leaf."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.models import transformer as jax_tf
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import transformer as tf
from repro_torch.train.tree import tree_leaves, tree_map

# (name, JAX policy, port policy): bf16 weights, weight-only QAT and W4A4 QAT,
# both with the straight-through estimator
POLICIES = {
    "bf16": (JaxPolicy.bf16(), QuantPolicy.bf16()),
    "qat_w4": (JaxPolicy.fakequant(ste=True), QuantPolicy.fakequant(ste=True)),
    "qat_w4a4": (JaxPolicy.fakequant(act_format="razer", ste=True),
                 QuantPolicy.fakequant(act_format="razer", ste=True)),
}
# W4A4 without the estimator: on the CPU the gradient runs through the
# activation quantizer's own ops on both sides (the card refuses it: K2 has
# no backward)
NO_STE = {"w4a4_no_ste": (JaxPolicy.fakequant(act_format="razer"), QuantPolicy.fakequant(act_format="razer"))}


def configs(arch: str):
    """(JAX config, port config): reduced, f32 compute."""
    return (dataclasses.replace(jax_get_config(arch).reduced(), compute_dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32"))


def jax_params(jcfg, seed: int = 0):
    """The JAX package's initial parameters as a numpy tree."""
    return jax.tree_util.tree_map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(seed), jcfg))


def tokens_labels(cfg, b: int, s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))


def port_tree(np_tree):
    """A JAX-layout numpy tree (stacked layer groups) as the port's tree."""
    return params_from_numpy(np_tree, device="cpu")


def max_rel_diff(port, ref_np):
    """max over leaves of max |port - ref| / max |ref| (ref a JAX-layout
    numpy tree), and the names of leaves whose nonzero positions differ."""
    worst, pattern = 0.0, []
    ref = tree_leaves(port_tree(ref_np))
    for i, (a, b) in enumerate(zip(tree_leaves(port), ref)):
        a = a.detach().to(torch.float32)
        worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
        if not torch.equal(a != 0, b != 0):
            pattern.append(i)
    assert len(tree_leaves(port)) == len(ref)
    return worst, pattern


def run_loss_case(arch: str, policy: str):
    """``lm_loss`` and its gradient tree, the port against
    ``jax.value_and_grad`` of the reference's, on 2 x 16 tokens: the loss
    within 1e-5 relative, the aux loss alike, each gradient leaf within 1e-4
    of its largest magnitude with the same nonzero positions.  Returns the
    port's gradient tree."""
    jcfg, cfg = configs(arch)
    raw = jax_params(jcfg)
    tokens, labels = tokens_labels(cfg, 2, 16)
    jq, tq = {**POLICIES, **NO_STE}[policy]
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(lambda p: jax_tf.lm_loss(p, batch, jcfg, jq), has_aux=True))(raw)
    params = port_tree(raw)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, m = tf.lm_loss(params, {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}, cfg, tq)
    it = iter(torch.autograd.grad(loss, leaves, allow_unused=True))  # unused: a zero gradient
    grads = tree_map(lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(next(it)), params)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(m["aux"].detach()) - float(jm["aux"])) <= 1e-5 * max(abs(float(jm["aux"])), 1.0)
    worst, pattern = max_rel_diff(grads, jax.tree_util.tree_map(np.asarray, jgrads))
    assert worst <= 1e-4, worst
    assert pattern == [], pattern
    return grads
