"""Rank side of the port's mesh-training tests: worlds of 1, 2 or 4
processes, spawned, over gloo on the CPU.

``run_world(world, jobs, tmp_path)`` starts ``world`` ranks that join one
process group through a file in ``tmp_path``, run the named jobs in order
(with autograd on) and save their results; the parent joins every rank with
a timeout, so a hang fails the test instead of running out the suite's
clock.  A job builds its train mesh over that process group
(``make_test_mesh``) and returns numpy arrays, lists and dicts.

This module imports torch and the port only (no JAX): the ranks never load
the JAX package.  The reference's weights and batches arrive as pickles of
numpy arrays written by the test.
"""
import contextlib
import dataclasses
import io
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 240
LR = 1e-4
STEPS = 3


def run_world(world: int, jobs, tmp_path, timeout: float = JOIN_TIMEOUT_S):
    """Run ``jobs`` [(name, kwargs)] on ``world`` spawned ranks; returns
    ``results[rank][i]`` for job i.  Raises with a rank's traceback if one
    failed, or after ``timeout`` seconds with every rank still alive
    terminated."""
    init = os.path.join(str(tmp_path), f"pg_init_{world}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, str(tmp_path), jobs)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(str(tmp_path), f"rank{r}.err")
        if os.path.exists(path):
            errors.append(f"rank {r}:\n" + open(path).read())
    if alive:
        raise TimeoutError(f"world {world}: {len(alive)} rank(s) still running after {timeout} s\n"
                           + "\n".join(errors))
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"world {world} failed (exit codes {[p.exitcode for p in procs]})\n" + "\n".join(errors))
    out = []
    for r in range(world):
        with open(os.path.join(str(tmp_path), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, world, init, out_dir, jobs):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
        results = [JOBS[name](**kwargs) for name, kwargs in jobs]
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3_2_3b").reduced(), compute_dtype="float32")


def policy(name):
    from repro_torch.core.policy import QuantPolicy

    return {"bf16": QuantPolicy.bf16(), "qat_w4": QuantPolicy.fakequant(ste=True),
            "qat_w4a4": QuantPolicy.fakequant(act_format="razer", ste=True)}[name]


def opt_cfg():
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS)


def mesh_of(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh(tuple(shape), tuple(axes), backend="gloo", device="cpu")


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def torch_batches(batches):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()} for b in batches]


def _flat(tree, placement=None, mesh=None):
    """The reference's flat {key: array} of a tree (gathered whole on a
    mesh; every rank gets it here)."""
    from repro_torch.bridge import gather_tree
    from repro_torch.train.checkpoint import flatten

    if mesh is not None:
        tree = gather_tree(tree, placement, mesh)
    return flatten(tree)


def _meta_shapes(tree):
    """{reference key: local shape} without copying: the layer groups'
    per-layer shapes keyed as the reference's stacked leaves."""
    from repro_torch.train.checkpoint import _SEP

    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{_SEP}{k}" if prefix else k, v)
        elif isinstance(node, list):
            walk(prefix, node[0])
        else:
            out[prefix] = tuple(node.shape)

    walk("", tree)
    return out


def run_steps(shape, pol, raw, batches, microbatch=0, axes=("data", "model"), donate=True):
    """``STEPS`` steps of ``bind_train_step`` on the mesh from the
    reference's weights; returns losses, gradient norms, the local shapes of
    params / m / v, the collectives' calls, and the whole final params."""
    from repro_torch.bridge import shards_from_numpy
    from repro_torch.parallel import collectives
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import bind_train_step

    cfg = config()
    mesh = mesh_of(shape, axes)
    step, p_shard, o_shard = bind_train_step(cfg, mesh, None, opt_cfg(), policy(pol), microbatch, donate)
    params = shards_from_numpy(raw, mesh, placement=p_shard)
    opt = init_opt_state(params)
    shapes = {"params": _meta_shapes(params), "m": _meta_shapes(opt.m), "v": _meta_shapes(opt.v)}
    calls0 = collectives.stats["calls"]
    losses, gnorms = [], []
    for b in torch_batches(batches):
        params, opt, m = step(params, opt, b)
        losses.append(np.float32(m["loss"]))
        gnorms.append(np.float32(m["grad_norm"]))
    return {"coords": (mesh.pod_index, mesh.data_index, mesh.model_index), "losses": losses, "grad_norms": gnorms,
            "shapes": shapes, "collective_calls": collectives.stats["calls"] - calls0,
            "params": _flat(params, p_shard, mesh)}


def run_meshless(pol, raw, batches, microbatch=0):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import make_train_step

    step = make_train_step(config(), None, opt_cfg(), policy(pol), microbatch)
    params = params_from_numpy(raw, device="cpu")
    opt = init_opt_state(params)
    losses, gnorms = [], []
    for b in torch_batches(batches):
        params, opt, m = step(params, opt, b)
        losses.append(np.float32(m["loss"]))
        gnorms.append(np.float32(m["grad_norm"]))
    return {"losses": losses, "grad_norms": gnorms, "params": _flat(params), "state": (params, opt)}


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------
def job_steps(shape, pol, params_file, batches_file, microbatch=0, axes=("data", "model"), donate=True):
    return run_steps(shape, pol, load(params_file), load(batches_file), microbatch, axes, donate)


def job_meshless(pol, params_file, batches_file, microbatch=0):
    out = run_meshless(pol, load(params_file), load(batches_file), microbatch)
    del out["state"]
    return out


def job_world1(params_file, batches_file, pols=("bf16", "qat_w4", "qat_w4a4")):
    """(1, 1) over one gloo rank against the meshless step on the same
    weights and batches: every loss, gradient norm, parameter and moment
    bit for bit; returns the meshless runs (the other meshes' yardstick)."""
    from repro_torch.bridge import shards_from_numpy
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import bind_train_step
    from repro_torch.train.tree import tree_leaves

    raw, batches = load(params_file), load(batches_file)
    out = {}
    for pol in pols:
        ref = run_meshless(pol, raw, batches)
        mesh = mesh_of((1, 1))
        step, p_shard, _ = bind_train_step(config(), mesh, None, opt_cfg(), policy(pol))
        params = shards_from_numpy(raw, mesh, placement=p_shard)
        opt = init_opt_state(params)
        identical = True
        for b, loss, gnorm in zip(torch_batches(batches), ref["losses"], ref["grad_norms"]):
            params, opt, m = step(params, opt, b)
            identical &= bool(np.float32(m["loss"]).tobytes() == loss.tobytes()
                              and np.float32(m["grad_norm"]).tobytes() == gnorm.tobytes())
        identical &= all(torch.equal(a, b) for a, b in zip(tree_leaves((params, opt)), tree_leaves(ref["state"])))
        del ref["state"]
        out[pol] = {**ref, "bit_identical": identical}
    return out


def job_absmax(shape):
    """Weight QAT's tensor scale on the mesh: one wq whose shards' absmax
    differ (one shard scaled by 7), through the mesh's compute slice
    (``_mesh_weight``) against the meshless fake-quant of the whole weight,
    sliced; and what quantizing the shard alone would give."""
    from repro_torch.core.qlinear import FakeQuantWeight
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.sharding import param_spec

    cfg, pol = config(), policy("qat_w4")
    mesh = mesh_of(shape)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((cfg.d_model, cfg.num_heads * cfg.hd)).astype(np.float32))
    place = param_spec("layers_0/mixer/wq", tuple(w.shape), mesh)
    w[: w.shape[0] // 2, : w.shape[1] // 2] *= 7.0  # the (0, 0) shard holds the absmax
    local = place.local(w, mesh).clone()
    got = tf._mesh_weight(local, place, mesh, False, pol.weight)
    assert isinstance(got, FakeQuantWeight)
    n = cfg.num_heads * cfg.hd // mesh.tp
    want = pol.weight.qdq(w, axis=0)[:, mesh.model_index * n:(mesh.model_index + 1) * n]
    alone = pol.weight.qdq(w[:, mesh.model_index * n:(mesh.model_index + 1) * n], axis=0)
    return {"equal": bool(torch.equal(got.w, want)), "alone_equal": bool(torch.equal(alone, want)),
            "local_absmax": float(local.abs().max())}


def job_checkpoint(params_file, batches_file, ckpt_dir):
    """One bf16 step on (2, 1), a checkpoint, then a restart on (1, 2) for
    the other steps; returns the checkpoint's step and the final params."""
    from repro_torch.bridge import shards_from_numpy
    from repro_torch.train.checkpoint import CheckpointManager, latest_step, restore_checkpoint
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainstep import bind_train_step

    cfg, raw, batches = config(), load(params_file), torch_batches(load(batches_file))
    mesh = mesh_of((2, 1))
    step, p_shard, o_shard = bind_train_step(cfg, mesh, None, opt_cfg(), policy("bf16"))
    params = shards_from_numpy(raw, mesh, placement=p_shard)
    state = {"params": params, "opt": init_opt_state(params)}
    mgr = CheckpointManager(ckpt_dir, every=1, mesh=mesh, placement={"params": p_shard, "opt": o_shard})
    p, o, _ = step(state["params"], state["opt"], batches[0])
    mgr.maybe_save(1, {"params": p, "opt": o})
    mgr.wait()

    mesh = mesh_of((1, 2))
    step, p_shard, o_shard = bind_train_step(cfg, mesh, None, opt_cfg(), policy("bf16"))
    template = shards_from_numpy(raw, mesh, placement=p_shard)
    template = {"params": template, "opt": init_opt_state(template)}
    state, at = restore_checkpoint(ckpt_dir, template, mesh=mesh, placement={"params": p_shard, "opt": o_shard})
    losses = []
    for b in batches[at:]:
        p, o, m = step(state["params"], state["opt"], b)
        state = {"params": p, "opt": o}
        losses.append(np.float32(m["loss"]))
    return {"latest": latest_step(ckpt_dir), "restored_at": at, "losses": losses,
            "params": _flat(state["params"], p_shard, mesh)}


def job_launcher(ckpt_dir):
    """``launch.train --mesh 1x2 --backend gloo --device cpu --reduced``,
    two steps, on this world's ranks; returns what the rank printed."""
    from repro_torch.launch import train

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train.main(["--arch", "llama3_2_3b", "--reduced", "--device", "cpu", "--mesh", "1x2", "--backend", "gloo",
                    "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", ckpt_dir])
    return {"stdout": log.getvalue(), "rank": dist.get_rank()}


JOBS = {"steps": job_steps, "meshless": job_meshless, "world1": job_world1, "absmax": job_absmax, "checkpoint": job_checkpoint,
        "launcher": job_launcher}
