"""Checkpoints between the packages (``repro.train.checkpoint`` and the
port's ``repro_torch.train.checkpoint``: the same files, keys, stacked
shapes and f32 for bf16), pruning and ``latest_step``, the fault-tolerant
loop (``ResilientLoop``, ``FailureInjector``, ``StragglerPolicy``) and the
launchers' ``main(argv)`` on the CPU: the port's train launcher writes a
checkpoint that its serve launcher's ``--ckpt`` reads, and so does the
reference's."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_cases import configs, jax_params, port_tree
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer
from repro_torch.train.fault import FailureInjector, NodeFailure, ResilientLoop, StragglerPolicy
from repro_torch.train.tree import tree_map


def _jax_state(seed=0):
    jcfg, _ = configs("dbrx_132b")  # layer groups, MoE banks and a router
    params = jax_params(jcfg, seed)
    params = dict(params, embed=params["embed"].astype(jnp.bfloat16))  # a bf16 leaf: stored as f32
    opt = jax_opt.init_opt_state(params)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32), m=jax.tree_util.tree_map(lambda a: a + 0.5, opt.m))
    return {"params": params, "opt": opt}


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def _port_state(jstate):
    params = port_tree(_host(jstate["params"]))
    params["embed"] = params["embed"].to(torch.bfloat16)
    opt = optimizer.OptState(step=torch.tensor(int(jstate["opt"].step), dtype=torch.int32),
                             m=port_tree(jax.tree_util.tree_map(np.asarray, jstate["opt"].m)),
                             v=port_tree(jax.tree_util.tree_map(np.asarray, jstate["opt"].v)))
    return {"params": params, "opt": opt}


def _keyed(tree, prefix=""):
    """{path: tensor} of a tree of dicts, lists and NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _keyed(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _keyed(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _equal(a, b):
    ka, kb = _keyed(a), _keyed(b)
    assert sorted(ka) == sorted(kb)
    for key, x in ka.items():
        assert x.dtype == kb[key].dtype and torch.equal(x, kb[key]), key


def _template(state):
    return tree_map(torch.zeros_like, state)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jax_ckpt.save_checkpoint(str(tmp_path), 7, jstate)
    want = _port_state(jstate)
    got, step = ckpt.restore_checkpoint(str(tmp_path), _template(want))
    assert step == 7
    _equal(got, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _jax_state()
    ckpt.save_checkpoint(str(tmp_path), 7, _port_state(jstate))
    template = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    got, step = jax_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    # the same files: keys, shapes and dtypes of the npz
    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, jstate)
    with np.load(tmp_path / "step_00000007" / "shard_00000.npz") as z, \
            np.load(tmp_path / "ref" / "step_00000007" / "shard_00000.npz") as r:
        assert sorted(z.files) == sorted(r.files)
        for k in r.files:
            assert z[k].shape == r[k].shape and z[k].dtype == r[k].dtype, k


def test_prune_latest_step_and_errors(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path), state)
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == jax_ckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_checkpoint(str(tmp_path), {"x": state["w"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3, 2)})
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), keep=3, every=2)
    assert not mgr.maybe_save(1, state)
    assert mgr.maybe_save(2, state)
    state["w"].add_(100)  # the host copy was taken before the thread started
    mgr.wait()
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "m"), state)
    assert float(got["w"].max()) == 5.0
    (tmp_path / "blocked").write_text("a file where the directory should be")
    bad = ckpt.CheckpointManager(str(tmp_path / "blocked"), every=1)
    bad.maybe_save(1, state)
    with pytest.raises(OSError):  # a failed background save surfaces in the training thread
        bad.wait()


def _counter_loop(tmp_path, injector, every):
    """A loop whose state is a running sum of its step numbers."""
    mgr = ckpt.CheckpointManager(str(tmp_path), every=every)
    loop = ResilientLoop(mgr, injector=injector)

    def step_fn(state, step):
        return {"acc": state["acc"] + step, "n": state["n"] + 1}

    state, end = loop.run({"acc": torch.tensor(0.0), "n": torch.tensor(0)}, step_fn, start_step=0, num_steps=6)
    return state, end, loop


def test_resilient_loop_restarts_from_the_newest_checkpoint(tmp_path):
    clean, end, _ = _counter_loop(tmp_path / "clean", None, every=2)
    assert end == 6 and float(clean["acc"]) == 15.0
    state, end, loop = _counter_loop(tmp_path / "failed", FailureInjector(fail_at_steps=(3,)), every=2)
    assert loop.restarts == 1 and end == 6
    assert float(state["acc"]) == float(clean["acc"]) and int(state["n"]) == int(clean["n"])


def test_resilient_loop_replays_from_start_with_nothing_saved(tmp_path):
    # the reference's behaviour: nothing saved yet, so steps replay from the
    # start on the state as it stands (steps 0 and 1 count twice)
    state, end, loop = _counter_loop(tmp_path, FailureInjector(fail_at_steps=(2,)), every=0)
    assert loop.restarts == 1 and end == 6
    assert int(state["n"]) == 8 and float(state["acc"]) == 16.0


def test_resilient_loop_gives_up_after_max_restarts(tmp_path):
    loop = ResilientLoop(ckpt.CheckpointManager(str(tmp_path), every=0),
                         injector=FailureInjector(fail_at_steps=(0, 1)), max_restarts=1)
    with pytest.raises(NodeFailure):
        loop.run({"x": torch.tensor(0)}, lambda s, i: s, start_step=0, num_steps=3)


def test_straggler_policy_requests_a_rebalance():
    policy = StragglerPolicy(factor=3.0, tolerance=2)
    assert not any(policy.observe(1.0) for _ in range(5))
    assert not policy.observe(5.0)
    assert policy.observe(5.0)
    assert policy.rebalance_requests == 1 and policy.slow_steps == 0
    policy.observe(1.0)
    assert policy.slow_steps == 0


def test_launchers_train_then_serve_from_either_checkpoint(tmp_path, capsys):
    from repro.launch import train as jax_train
    from repro_torch.launch import serve, train

    common = ["--arch", "llama3_2_3b", "--reduced", "--steps", "4", "--batch", "2", "--seq", "16"]
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    train.main(common + ["--ckpt-every", "2", "--ckpt-dir", port_dir, "--device", "cpu", "--qat"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and f"done at step 4; checkpoints in {port_dir}" in out
    assert sorted(os.listdir(port_dir)) == ["step_00000002", "step_00000004"]
    train.main(common + ["--ckpt-dir", port_dir, "--device", "cpu"])  # resumes at the end: nothing to do
    assert "resumed from step 4" in capsys.readouterr().out
    jax_train.main(common[:3] + ["--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir", ref_dir])
    capsys.readouterr()
    for d in (port_dir, ref_dir):
        serve.main(["--arch", "llama3_2_3b", "--reduced", "--device", "cpu", "--ckpt", d, "--requests", "2",
                    "--max-new", "3"])
        out = capsys.readouterr().out
        assert f"restored params from step {4 if d == port_dir else 2}" in out and "prompt[" in out
    # the port's restored params are the reference's restored tree
    _, cfg = configs("llama3_2_3b")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    from repro_torch.models.transformer import init_params

    got, _ = ckpt.restore_checkpoint(ref_dir, {"params": init_params(cfg, device="cpu")})
    from repro.configs import get_config as jget
    from repro.models import transformer as jax_tf

    jtemplate = {"params": jax_tf.init_params(jax.random.PRNGKey(0), jget("llama3_2_3b").reduced())}
    want, _ = jax_ckpt.restore_checkpoint(ref_dir, jtemplate)
    _equal(got["params"], port_tree(jax.tree_util.tree_map(np.asarray, want["params"])))
