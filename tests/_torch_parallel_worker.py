"""Rank side of the port's multi-rank tests: worlds of 1, 2 or 4 processes,
spawned, over gloo on the CPU.

``run_world(world, jobs, tmp_path)`` starts ``world`` ranks that join one
process group through a file in ``tmp_path`` (no port to race for between
pytest workers), run the named jobs in order and save their results; the
parent joins every rank with a timeout, so that a hang fails the test
instead of running out the suite's clock.  A job builds its own serving
mesh (``make_serving_mesh``, over the same process group) and returns numpy
arrays and lists: the mesh's result beside the meshless one, computed on
the same rank from the same seed, for the test to compare.

This module imports torch and the port only (no JAX): the ranks never load
the JAX package.
"""
import dataclasses
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 240


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
        results = []
        with torch.no_grad():
            for name, kwargs in jobs:
                results.append(JOBS[name](**kwargs))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _mesh(ep, tp):
    from repro_torch.launch.mesh import make_serving_mesh

    return make_serving_mesh(ep=ep, tp=tp, backend="gloo", device="cpu")


def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------
def job_qlinear(ep, tp, policy="w4", seed=0, k=128, n=96, m=5):
    """A packed linear on the mesh (K-sharded when eligible) against the
    meshless one, plus the K7 plain partial path's pieces."""
    from repro_torch.core.packing import pack_weight
    from repro_torch.core.qlinear import qlinear
    from repro_torch.parallel.sharding import shard_params, sharding_ctx

    mesh = _mesh(ep, tp)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k))
    x = torch.from_numpy(rng.standard_normal((2, m, k)).astype(np.float32))
    pol = _policy(policy)
    pw = pack_weight(w)
    local = shard_params({"w": pw}, mesh)["w"]
    ref = qlinear(x, pw, pol)
    with sharding_ctx(mesh):
        got = qlinear(x, local, pol)
    return {"k_shards": local.k_shards, "local_shape": tuple(local.shape), "got": _np(got), "ref": _np(ref)}


def _policy(name):
    from repro_torch.core.policy import QuantPolicy, TensorSpec

    w4 = QuantPolicy.packed(kv_quant=True)
    if name == "w4a4":
        return QuantPolicy(weight=w4.weight, act=TensorSpec.act("razer"), kv=w4.kv, rules=w4.rules)
    return w4


def moe_cfg(**kw):
    from repro_torch.models.config import ArchConfig

    base = dict(name="t", family="moe", num_layers=1, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128, vocab_size=64, moe=True, n_experts=4, topk=2, moe_d_ff=64, capacity_factor=8.0,
                compute_dtype="float32")
    base.update(kw)
    return ArchConfig(**base)


def job_moe(ep, tp, tokens, seed=0, cfg_kw=None, params_file=None, x_file=None):
    """``moe_forward`` of a packed MoE layer on the mesh against the meshless
    one (same weights and tokens), with which strategy ran: the banks'
    (e_shards, k_shards), the group count and the all-to-all count.  With
    ``params_file`` / ``x_file`` the layer and tokens come from numpy files
    (the JAX package's weights), else from ``seed``."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.models import moe
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import shard_params, sharding_ctx
    from repro_torch.serving.engine import pack_model_weights

    mesh = _mesh(ep, tp)
    cfg = moe_cfg(**(cfg_kw or {}))
    if params_file:
        from repro_torch.bridge import params_from_numpy

        with open(params_file, "rb") as f:
            p = params_from_numpy(pickle.load(f), device="cpu")
        x = torch.from_numpy(np.load(x_file))
    else:
        gen = torch.Generator().manual_seed(seed)
        p = moe.moe_init(gen, cfg, device="cpu")
        x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((1, tokens, cfg.d_model))
                             .astype(np.float32))
    pol = QuantPolicy.packed()
    packed = pack_model_weights({"layers_0": {"moe": p}}, cfg, pol)["layers_0"]["moe"]
    ref, aux_ref = moe.moe_forward(x, packed, cfg, quant=pol)
    local = shard_params({"moe": packed}, mesh)["moe"]
    # count the collectives each token strategy runs
    originals = {n: getattr(collectives, n) for n in ("dispatch_to_expert_shards", "combine_from_expert_shards",
                                                       "all_gather_first", "all_gather_last")}
    calls = dict.fromkeys(originals, 0)

    def counted(name):
        def run(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return run

    for name in originals:
        setattr(collectives, name, counted(name))
    try:
        with sharding_ctx(mesh):
            got, aux = moe.moe_forward(x, local, cfg, quant=pol)
            groups = moe._pick_groups(x.shape[0] * x.shape[1])
    finally:
        for name, fn in originals.items():
            setattr(collectives, name, fn)
    bank = local["experts"]["gate"]
    return {"shards": (bank.e_shards, bank.k_shards), "local_shape": tuple(bank.shape), "groups": groups,
            "calls": calls, "got": _np(got), "ref": _np(ref), "aux": float(aux), "aux_ref": float(aux_ref)}


def job_dispatch_roundtrip(ep, seed=0, g_local=2, e=4, cap=3, d=16):
    """dispatch -> combine is the identity on this rank's groups, and the
    dispatched slots of expert l are those every rank sent for it."""
    from repro_torch.parallel.collectives import combine_from_expert_shards, dispatch_to_expert_shards

    mesh = _mesh(ep, 1)
    bufs = [np.random.default_rng(seed + r).standard_normal((g_local, e, cap, d)).astype(np.float32)
            for r in range(ep)]
    mine = torch.from_numpy(bufs[mesh.data_index])
    x = dispatch_to_expert_shards(mine, mesh.ep_group)
    le = e // ep
    want = np.concatenate([b[:, mesh.data_index * le:(mesh.data_index + 1) * le] for b in bufs], axis=0)
    back = combine_from_expert_shards(x, mesh.ep_group)
    return {"dispatched": _np(x), "want": want, "back": _np(back), "mine": bufs[mesh.data_index]}


def job_quantized_all_gather(ep, seed=0, rows=6, cols=64):
    """Each rank's (rows, cols) shard gathered over the ep group in the wire
    format; returns the gathered values and this rank's shard."""
    from repro_torch.parallel.collectives import quantized_all_gather, wire_encode

    mesh = _mesh(ep, 1)
    x = np.random.default_rng(seed + mesh.data_index).standard_normal((rows, cols)).astype(np.float32) * 3
    got = quantized_all_gather(torch.from_numpy(x), mesh.ep_group)
    codes, meta, _ = wire_encode(torch.from_numpy(x))
    return {"got": _np(got), "x": x, "codes": codes.numpy().copy(), "meta": meta.numpy().copy()}


def _engine_cfg(arch, **kw):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32", **kw)


def job_engine(ep, tp, arch, policy="w4", seed=0, cfg_kw=None, params_file=None, n_new=4, serve=True,
               speculate=False):
    """Reduced ``arch`` through Engine.generate (and Engine.serve) on the
    mesh and meshless, from the same weights: prefill logits, generate
    tokens, serve outputs, and the K-shard placement of the packed tree."""
    from repro_torch.core.packing import PackedRazerWeight, PackedStackedTensor
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import Engine, ServeConfig
    from repro_torch.serving.pagepool import PagePoolConfig
    from repro_torch.serving.scheduler import Request, SchedulerConfig

    mesh = _mesh(ep, tp)
    cfg = _engine_cfg(arch, **(cfg_kw or {}))
    if params_file:
        from repro_torch.bridge import params_from_numpy

        with open(params_file, "rb") as f:
            params = params_from_numpy(pickle.load(f), device="cpu")
    else:
        params = init_params(cfg, seed=seed, device="cpu")
    scfg = ServeConfig(max_len=64, max_new_tokens=n_new, quant=_policy(policy))
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30], [5, 6, 7, 8]]
    toks = np.zeros((len(prompts), 16), np.int64)
    for i, q in enumerate(prompts):
        toks[i, :len(q)] = q
    lens = np.array([len(q) for q in prompts])
    out = {}
    for name, eng in (("ref", Engine(params, cfg, scfg, device="cpu")), ("got", Engine(params, cfg, scfg, mesh=mesh))):
        last, _ = eng._bucketed_prefill(toks, lens, max_len=64, qdq_kv=True)
        res = {"prefill_logits": _np(last), "generate": eng.generate(prompts)}
        if serve:
            runs = ((0, None), (2, "bf16")) if speculate else ((0, None),)
            for k, draft in runs:
                reqs = [Request(rid=i, prompt=q, max_new_tokens=n_new) for i, q in enumerate(prompts)]
                rep = eng.serve(reqs, sched_cfg=SchedulerConfig(max_slots=2),
                                pool_cfg=PagePoolConfig(num_pages=40, page_size=4, max_len=64),
                                speculate_k=k, draft_policy=draft)
                res[f"serve_k{k}"] = [list(r.out_tokens) for r in rep.requests]
        out[name] = res
        if name == "got":
            shards = []

            def walk(t):
                if isinstance(t, dict):
                    for v in t.values():
                        walk(v)
                elif isinstance(t, list):
                    for v in t:
                        walk(v)
                elif isinstance(t, (PackedRazerWeight, PackedStackedTensor)):
                    shards.append((type(t).__name__, getattr(t, "e_shards", 1), t.k_shards, tuple(t.shape)))

            walk(eng.params)
            out["shards"] = shards
    return out


def job_serve_cli(argv):
    """``python -m repro_torch.launch.serve`` on this rank, inside the
    world's process group; returns its new tokens per request."""
    from repro_torch.launch.serve import main

    return main(list(argv))


JOBS = {"serve_cli": job_serve_cli, "qlinear": job_qlinear, "moe": job_moe, "dispatch_roundtrip": job_dispatch_roundtrip,
        "quantized_all_gather": job_quantized_all_gather, "engine": job_engine}
