"""Every arch of ``ARCH_IDS`` trains on the CPU: ``lm_loss`` of the port
against the reference's on reduced configs (f32 compute), with each cell's
training inputs drawn by both packages' ``materialize`` (the frontend stubs'
patch embeddings and M-RoPE streams, whisper's frames); a gradient reaches
every leaf the reference's does.  ``forward_train``'s logits and the
prefill and decode steps of ``trainstep`` against the reference's.

Tolerances: the loss within 1e-5 relative (f32 sums in other orders);
logits within 1e-5 of their largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_cases import configs, jax_params, port_tree
from repro.configs import ARCH_IDS
from repro.models import inputs as jax_inputs
from repro.models import transformer as jax_tf
from repro.train import trainstep as jax_ts
from repro_torch.models import inputs
from repro_torch.models import transformer as tf
from repro_torch.train import trainstep
from repro_torch.train.tree import tree_leaves


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_of_every_arch_equals_the_reference(arch):
    jcfg, cfg = configs(arch)
    raw = jax_params(jcfg)
    jbatch = jax_inputs.materialize(jax_inputs.train_input_specs(jcfg, 16, 2), seed=1, vocab=jcfg.vocab_size)
    batch = inputs.materialize(inputs.train_input_specs(cfg, 16, 2), seed=1, vocab=cfg.vocab_size, device="cpu")
    want, _ = jax.jit(lambda p, b: jax_tf.lm_loss(p, b, jcfg))(raw, jbatch)
    params = port_tree(raw)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    got, _ = tf.lm_loss(params, batch, cfg)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want)), (float(got), float(want))
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_forward_train_logits_equal_the_reference():
    jcfg, cfg = configs("llama3_2_3b")
    raw = jax_params(jcfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, waux = jax_tf.forward_train(raw, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        got, aux = tf.forward_train(port_tree(raw), torch.from_numpy(tokens), cfg)
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
    assert float(aux) == float(waux) == 0.0


def test_prefill_and_decode_steps_equal_the_reference():
    jcfg, cfg = configs("llama3_2_3b")
    raw = jax_params(jcfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jlogits, jcaches, _ = jax_ts.make_prefill_step(jcfg, None, 16)(raw, {"tokens": jnp.asarray(tokens)})
    params = port_tree(raw)
    logits, caches, _ = trainstep.make_prefill_step(cfg, None, 16)(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5 * float(np.abs(jlogits).max()))
    nxt = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    jstep, _ = jax_ts.make_decode_step(jcfg, None)(raw, jnp.asarray(nxt), jcaches, jnp.asarray(8, jnp.int32))
    step, _ = trainstep.make_decode_step(cfg, None)(params, torch.from_numpy(nxt), caches,
                                                    torch.full((2,), 8, dtype=torch.int32))
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=0, atol=1e-5 * float(np.abs(jstep).max()))
