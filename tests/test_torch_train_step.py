"""The port's optimizer, data and train step against the JAX package's
(``repro.train.{optimizer,data,trainstep}``), reduced configs, f32 compute.

Tolerances: ``lr_at`` within 2 f32 ulps (XLA's and PyTorch's f32 ``cos``
may round apart); ``global_norm`` within 1e-6 relative (f32 sums over other
groupings: the reference's leaves are scan-stacked); one ``adamw_update`` on
the same parameters and gradients within 1e-6 of each leaf's largest
magnitude.  ``SyntheticLM`` batches are numpy on both sides and equal.
Three ``make_train_step`` steps: losses within 1e-5 relative; parameters
within 4 x the summed learning rate (an element whose gradient is near 0 can
flip its Adam update's sign, about 2 lr a step), all but 0.1 % of them
within 1e-6.  Remat "full", "dots" and "none" give the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_cases import configs, jax_params, port_tree, tokens_labels
from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro.train import trainstep as jax_ts
from repro_torch.models import transformer as tf
from repro_torch.train import data, optimizer
from repro_torch.train.trainstep import make_train_step
from repro_torch.train.tree import tree_leaves

OPT = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _jax_opt_cfg(cfg):
    return jax_opt.AdamWConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7, 10, 12])
def test_lr_at_equals_the_reference(step):
    want = np.float32(jax_opt.lr_at(jnp.float32(step), _jax_opt_cfg(OPT)))
    got = np.float32(optimizer.lr_at(torch.tensor(float(step)), OPT))
    assert abs(int(want.view(np.int32)) - int(got.view(np.int32))) <= 2, (got, want)


def _random_tree(seed):
    jcfg, _ = configs("llama3_2_3b")
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jax_params(jcfg))


def test_global_norm_equals_the_reference():
    tree = _random_tree(1)
    want = float(jax_opt.global_norm(tree))
    assert abs(float(optimizer.global_norm(port_tree(tree))) - want) <= 1e-6 * want


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "unclipped"])
def test_adamw_update_equals_the_reference(clip):
    cfg = dataclasses.replace(OPT, grad_clip=clip)
    params, grads = _random_tree(2), _random_tree(3)
    jstate = jax_opt.init_opt_state(params)
    jp, jstate, jm = jax_opt.adamw_update(params, grads, jstate, _jax_opt_cfg(cfg))
    jp, _, _ = jax_opt.adamw_update(jp, grads, jstate, _jax_opt_cfg(cfg))  # a second step: m, v nonzero
    p = port_tree(params)
    state = optimizer.init_opt_state(p)
    p, state, m = optimizer.adamw_update(p, port_tree(grads), state, cfg)
    p, state, _ = optimizer.adamw_update(p, port_tree(grads), state, cfg)
    assert int(state.step) == 2
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6 * float(jm["grad_norm"])
    for a, b in zip(tree_leaves(p), tree_leaves(port_tree(jax.tree_util.tree_map(np.asarray, jp)))):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_the_reference(shard):
    cfg = dict(vocab_size=300, seq_len=24, global_batch=4, seed=5)
    want = jax_data.SyntheticLM(jax_data.DataConfig(**cfg)).batch(3, *shard)
    got = data.SyntheticLM(data.DataConfig(**cfg)).batch(3, *shard)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
    for a, b in zip(data.calibration_batches(None, n=2), jax_data.calibration_batches(None, n=2)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def _batches(cfg, n, b=4, s=16):
    ds = data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b))
    return [ds.batch(i) for i in range(n)]


@pytest.mark.parametrize("microbatch", [0, 2], ids=["whole", "microbatch2"])
def test_three_train_steps_equal_the_reference(microbatch):
    jcfg, cfg = configs("llama3_2_3b")
    raw = jax_params(jcfg)
    opt = optimizer.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=3)
    jstep = jax_ts.make_train_step(jcfg, None, _jax_opt_cfg(opt), microbatch=microbatch)
    jp, jo = raw, jax_opt.init_opt_state(raw)
    step = make_train_step(cfg, None, opt, microbatch=microbatch)
    p = port_tree(raw)
    o = optimizer.init_opt_state(p)
    for b in _batches(cfg, 3):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        p, o, m = step(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    want = tree_leaves(port_tree(jax.tree_util.tree_map(np.asarray, jp)))
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(p), want)])
    assert float(diffs.max()) <= 4 * 3 * opt.lr
    assert float((diffs > 1e-6).float().mean()) <= 1e-3


def test_remat_policies_give_the_same_gradients():
    jcfg, cfg = configs("llama3_2_3b")
    raw = jax_params(jcfg)
    tokens, labels = tokens_labels(cfg, 2, 16)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    out = {}
    for policy in ("full", "dots", "none"):
        params = port_tree(raw)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        token = tf.REMAT_POLICY.set(policy)
        try:
            loss, _ = tf.lm_loss(params, batch, cfg)
        finally:
            tf.REMAT_POLICY.reset(token)
        out[policy] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for policy in ("dots", "none"):
        assert torch.equal(out[policy][0], out["full"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[policy][1], out["full"][1])), policy


def test_a_mesh_raises():
    _, cfg = configs("llama3_2_3b")
    with pytest.raises(ValueError, match="meshless"):
        make_train_step(cfg, object(), OPT)
