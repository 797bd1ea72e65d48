"""Training on a mesh of gloo ranks on the CPU: reduced llama3_2_3b in f32
through ``bind_train_step`` on the (1, 1), (2, 1), (1, 2) and (2, 2) meshes
and a (pod, data, model) = (2, 1, 2) mesh, under bf16, weight QAT and W4A4
QAT (``_torch_train_mesh_worker.py``: worlds of 1, 2 and 4 spawned ranks),
against the JAX package's ``bind_train_step`` on the same meshes (two
subprocesses on four forced host devices, ``_torch_train_mesh_jax_ref.py``:
weight QAT on (2, 1) and (1, 2), W4A4 on (1, 2) and (2, 2), bf16 with a
mask whose rows differ and ``microbatch`` 2 on (2, 2), bf16 on the pod
mesh) and every case against the port's meshless step (itself held to the
JAX package by ``test_torch_train_step.py``).  Everything runs at once:
the two subprocesses and the three worlds.

Bounds, ``test_torch_train_step.py``'s: losses within 1e-5 relative,
gradient norms within 1e-4 relative, parameters within 4 x the summed
learning rate and all but 0.1 % of them within 1e-6; every rank's loss and
gradient norm the same bits.  The (1, 1) mesh is the meshless step bit for
bit.  Each rank's parameter, m and v shapes equal ``NamedSharding(mesh,
spec).shard_shape`` of the reference's ``param_sharding_tree``.
"""
import concurrent.futures
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

import _torch_train_mesh_jax_ref as jref
from _torch_train_mesh_worker import LR, STEPS, run_world

REPO = pathlib.Path(__file__).resolve().parent.parent
POLS = ("bf16", "qat_w4", "qat_w4a4")
# each JAX case and the port's run of it: (world, index of the job there)
JAX_CASES = {"bf16_mask_mb2_2x2": (4, 3), "qat_w4_2x1": (2, 1), "qat_w4_1x2": (2, 4), "qat_w4a4_1x2": (2, 5),
             "qat_w4a4_2x2": (4, 2), "bf16_pod_2x1x2": (4, 4)}
# the JAX cases split over two processes of about equal tracing time
JAX_PROCS = (("qat_w4a4_1x2", "qat_w4_2x1", "bf16_pod_2x1x2"), ("qat_w4a4_2x2", "qat_w4_1x2", "bf16_mask_mb2_2x2"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = tmp_path_factory.mktemp("train_mesh_inputs")
    params, data = jref.write_inputs(str(inputs))
    b3 = [{k: v[:3] for k, v in b.items()} for b in data[False]]  # a batch the data axis does not divide
    with open(inputs / "batches3.pkl", "wb") as f:
        pickle.dump(b3, f)
    files = dict(params_file=str(inputs / "params.pkl"), batches_file=str(inputs / "batches.pkl"))
    mask = dict(files, batches_file=str(inputs / "batches_mask.pkl"))
    jax_outs = [tmp_path_factory.mktemp("train_mesh_jax") for _ in JAX_PROCS]
    ckpt = tmp_path_factory.mktemp("train_mesh_ckpt")
    launch = tmp_path_factory.mktemp("train_mesh_launch")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    worlds = {
        1: [("world1", files), ("meshless", dict(files, pol="bf16", batches_file=str(inputs / "batches3.pkl")))],
        2: [("steps", dict(files, shape=s, pol=p)) for s in ((2, 1), (1, 2)) for p in POLS]
           + [("steps", dict(files, shape=(2, 1), pol="bf16", batches_file=str(inputs / "batches3.pkl"))),
              ("absmax", dict(shape=(1, 2))), ("absmax", dict(shape=(2, 1))),
              ("checkpoint", dict(files, ckpt_dir=str(ckpt))), ("launcher", dict(ckpt_dir=str(launch)))],
        4: [("steps", dict(files, shape=(2, 2), pol=p)) for p in POLS]
           + [("steps", dict(mask, shape=(2, 2), pol="bf16", microbatch=2)),
              ("steps", dict(files, shape=(2, 1, 2), axes=("pod", "data", "model"), pol="bf16", donate=False))],
    }
    with concurrent.futures.ThreadPoolExecutor(len(JAX_PROCS) + len(worlds)) as pool:
        refs = [pool.submit(subprocess.run, [sys.executable, str(REPO / "tests" / "_torch_train_mesh_jax_ref.py"),
                                             str(out), *names], capture_output=True, text=True, env=env, timeout=600)
                for out, names in zip(jax_outs, JAX_PROCS)]
        got = {w: pool.submit(run_world, w, jobs, tmp_path_factory.mktemp(f"train_mesh_world{w}"))
               for w, jobs in worlds.items()}
        got = {w: f.result() for w, f in got.items()}
        procs = [f.result() for f in refs]
    jax_res = {}
    for proc, out in zip(procs, jax_outs):
        assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
        with open(out / "jax_out.pkl", "rb") as f:
            jax_res.update(pickle.load(f))
    assert sorted(jax_res) == sorted(JAX_CASES)
    return {"params": params, "data": data, "worlds": got, "jax": jax_res, "ckpt": ckpt, "launch": launch}


def _close(got, want):
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), (got["losses"], want["losses"])
    for a, b in zip(got["grad_norms"], want["grad_norms"]):
        assert abs(float(a) - float(b)) <= 1e-4 * float(b), (got["grad_norms"], want["grad_norms"])
    assert sorted(got["params"]) == sorted(want["params"])
    diffs = np.concatenate([np.abs(got["params"][k] - want["params"][k]).ravel() for k in want["params"]])
    assert float(diffs.max()) <= 4 * STEPS * LR, float(diffs.max())
    assert float((diffs > 1e-6).mean()) <= 1e-3, float((diffs > 1e-6).mean())


def _ranks_agree(ranks):
    for r in ranks[1:]:
        assert [x.tobytes() for x in r["losses"]] == [x.tobytes() for x in ranks[0]["losses"]]
        assert [x.tobytes() for x in r["grad_norms"]] == [x.tobytes() for x in ranks[0]["grad_norms"]]


def _job(runs, world, index):
    return [rank[index] for rank in runs["worlds"][world]]


def test_world_of_one_is_the_meshless_step_bit_for_bit(runs):
    res = runs["worlds"][1][0][0]
    assert all(res[p]["bit_identical"] for p in POLS), {p: res[p]["bit_identical"] for p in POLS}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_steps_match_the_jax_package_on_the_same_mesh(runs, name):
    ranks = _job(runs, *JAX_CASES[name])
    _ranks_agree(ranks)
    for r in ranks:
        _close(r, runs["jax"][name])


@pytest.mark.parametrize("world, index, shape, pol", [(2, i, s, p) for i, (s, p) in enumerate(
    [((2, 1), p) for p in POLS] + [((1, 2), p) for p in POLS])] + [(4, i, (2, 2), p) for i, p in enumerate(POLS)]
    + [(4, 4, (2, 1, 2), "bf16")])
def test_steps_match_the_meshless_step(runs, world, index, shape, pol):
    ranks = _job(runs, world, index)
    _ranks_agree(ranks)
    assert len({r["coords"] for r in ranks}) == len(ranks)
    for r in ranks:
        _close(r, runs["worlds"][1][0][0][pol])
        assert r["collective_calls"] > 0


def test_a_batch_the_data_axis_does_not_divide_is_replicated(runs):
    """3 rows on (2, 1): ``input_sharding`` replicates them, each replica
    differentiates them all and the step divides by the 2 replicas."""
    ranks = _job(runs, 2, 6)
    _ranks_agree(ranks)
    for r in ranks:
        _close(r, runs["worlds"][1][0][1])


def test_the_mask_takes_the_global_normalizer(runs):
    """Rows whose masks differ: the mesh's loss is the JAX package's, and a
    mean of each data shard's own mean would be another number."""
    import torch

    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import transformer as tf
    from _torch_train_mesh_worker import config

    got = _job(runs, 4, 3)[0]["losses"][0]
    assert abs(float(got) - float(runs["jax"]["bf16_mask_mb2_2x2"]["losses"][0])) <= 1e-5 * abs(float(got))
    p = params_from_numpy(runs["params"], device="cpu")
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in runs["data"][True][0].items()}
    per_shard = [float(tf.lm_loss(p, {k: v[i:i + 1] for k, v in b.items()}, config())[0]) for i in range(4)]
    variant = np.mean([np.mean(per_shard[:2]), np.mean(per_shard[2:])])  # 2 microbatches of 1 row a data rank
    assert abs(variant - float(got)) > 10 * 1e-5 * abs(float(got)), (variant, got)


def _reference_shard_shapes(params, shape, axes):
    from repro.parallel.sharding import param_sharding_tree

    mesh = AbstractMesh(tuple(shape), tuple(axes))
    tree = param_sharding_tree(jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params), mesh)
    out = {}

    def walk(prefix, sh, leaf):
        if isinstance(sh, dict):
            for k in sh:
                walk(f"{prefix}::{k}" if prefix else k, sh[k], leaf[k])
        else:
            s = NamedSharding(mesh, sh.spec).shard_shape(leaf.shape)
            out[prefix] = tuple(s[1:]) if prefix.startswith("layers_") else tuple(s)

    walk("", tree, params)
    return out


@pytest.mark.parametrize("world, index, shape, axes", [(2, 0, (2, 1), ("data", "model")),
                                                       (2, 3, (1, 2), ("data", "model")),
                                                       (4, 0, (2, 2), ("data", "model")),
                                                       (4, 4, (2, 1, 2), ("pod", "data", "model"))])
def test_each_rank_holds_the_reference_shard_shapes(runs, world, index, shape, axes):
    want = _reference_shard_shapes(runs["params"], shape, axes)
    for r in _job(runs, world, index):
        for part in ("params", "m", "v"):
            assert r["shapes"][part] == want, (part, r["coords"])


def test_weight_qat_quantizes_the_gathered_weight(runs):
    """One shard holds the weight's absmax: every rank's fake-quantized
    slice is the whole weight's, bit for bit; where the shard's own absmax
    is smaller, quantizing it alone gives other bits."""
    for index in (7, 8):
        ranks = _job(runs, 2, index)
        assert all(r["equal"] for r in ranks)
    assert not all(r["alone_equal"] for r in _job(runs, 2, 7))


def test_a_checkpoint_crosses_meshes_and_packages(runs):
    """Saved at (2, 1) after one step, restored at (1, 2) for the other two:
    the end equals the unbroken (2, 1) run; the same checkpoint restores
    meshless (the one-step meshless state) and into the JAX package (the
    same arrays)."""
    import torch
    from repro.train import checkpoint as jax_ckpt
    from repro.train import optimizer as jax_opt

    from repro_torch.bridge import params_from_numpy
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.tree import tree_leaves
    from _torch_train_mesh_worker import _flat, run_meshless

    ranks = _job(runs, 2, 9)
    for r in ranks:
        assert r["latest"] == 1 and r["restored_at"] == 1 and len(r["losses"]) == STEPS - 1
        _close({**r, "losses": [], "grad_norms": []}, _job(runs, 2, 0)[0])
    template = params_from_numpy(runs["params"], device="cpu")
    template = {"params": template, "opt": init_opt_state(template)}
    state, at = restore_checkpoint(str(runs["ckpt"]), template)
    one = run_meshless("bf16", runs["params"], runs["data"][False][:1])
    _close({"losses": [], "grad_norms": [], "params": _flat(state["params"])}, one)
    jtemplate = {"params": runs["params"], "opt": jax_opt.OptState(step=np.zeros((), np.int32), m=runs["params"],
                                                                    v=runs["params"])}
    jstate, jat = jax_ckpt.restore_checkpoint(str(runs["ckpt"]), jtemplate)
    assert at == jat == 1
    mine = tree_leaves(state["params"])
    theirs = tree_leaves(params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]), device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))


def test_the_launcher_trains_on_a_1x2_mesh(runs):
    ranks = _job(runs, 2, 10)
    out = {r["rank"]: r["stdout"] for r in ranks}
    assert "step     0 loss" in out[0] and "done at step 2" in out[0] and "mesh {'data': 1, 'model': 2}" in out[0]
    assert out[1] == ""
    assert sorted(os.listdir(runs["launch"])) == ["step_00000002"]
