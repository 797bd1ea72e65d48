"""Training launcher of the port (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch llama3_2_3b --reduced --device cpu \\
        --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/run1
    python -m repro_torch.launch.train --arch llama3_2_3b --steps 20 --batch 1 --seq 4096 --qat
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train --arch llama3_2_3b \
        --reduced --device cpu --mesh 1x2 --backend gloo --steps 4 --batch 2 --seq 32

Random weights from seed 0 (``init_params``), AdamW with a cosine schedule,
the synthetic Markov data of ``train.data``; ``--qat`` trains under RaZeR
fake-quant with a straight-through estimator.  Every 10 steps it prints the
loss, learning rate, gradient norm and seconds; checkpoints go to
``--ckpt-dir`` (the reference's layout, which ``launch.serve --ckpt`` of
either package reads) every ``--ckpt-every`` steps and at the end, and a
restart resumes from the newest.

``--mesh`` trains on a mesh of ``torch.distributed`` ranks: ``single`` /
``multi`` the reference's production mesh (16 x 16, 2 x 16 x 16), ``DxM``
a (data, model) test mesh of D x M ranks.  ``--backend`` names the process
group's backend (NCCL with one rank per card, gloo where ranks share one)
and ``--init-method`` how the ranks meet (``env://`` under torchrun).  Each
rank builds the seed-0 weights, keeps its shards, and steps the same
global batch; rank 0 prints and writes the checkpoints (whole leaves, so a
restart may take another mesh, or none).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    help="none (one device), single / multi (the production mesh: 16 x 16, 2 x 16 x 16 ranks) or "
                         "DxM (a data x model test mesh)")
    ap.add_argument("--backend", default="nccl", help="torch.distributed backend of the mesh (nccl, gloo)")
    ap.add_argument("--init-method", default="env://",
                    help="how the mesh's ranks meet (env:// under torchrun, file://PATH, tcp://localhost:PORT)")
    ap.add_argument("--qat", action="store_true", help="RaZeR fake-quant QAT forward (straight-through estimator)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    shape = None
    if args.mesh not in ("none", "single", "multi"):
        try:
            shape = tuple(int(n) for n in args.mesh.lower().split("x"))
        except ValueError:
            shape = ()
        if len(shape) != 2:
            ap.error(f"--mesh takes none, single, multi or DxM, got {args.mesh!r}")
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.device import resolve_device, sync
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import local_tree
    from repro_torch.train.checkpoint import CheckpointManager, latest_step, restore_checkpoint
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.fault import ResilientLoop, StragglerPolicy
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import bind_train_step, make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    quant = QuantPolicy.fakequant(ste=True) if args.qat else QuantPolicy.bf16()
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))

    mesh, placement = None, None
    if args.mesh != "none":
        from repro_torch.launch import mesh as mesh_mod

        kw = dict(backend=args.backend, device=device, init_method=args.init_method)
        mesh = (mesh_mod.make_test_mesh(shape, **kw) if shape else
                mesh_mod.make_production_mesh(multi_pod=args.mesh == "multi", **kw))
        device = mesh.device
        train_step, p_shard, o_shard = bind_train_step(cfg, mesh, None, ocfg, quant, args.microbatch)
        placement = {"params": p_shard, "opt": o_shard}
        params = local_tree(init_params(cfg, seed=0, device=device), p_shard, mesh)
    else:
        train_step = make_train_step(cfg, None, ocfg, quant, args.microbatch)
        params = init_params(cfg, seed=0, device=device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    state = {"params": params, "opt": init_opt_state(params)}
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"razer_{args.arch}_ckpt")
    mgr = CheckpointManager(ckpt_dir, every=args.ckpt_every, mesh=mesh, placement=placement)
    start = latest_step(ckpt_dir) or 0
    if start:
        state, start = restore_checkpoint(ckpt_dir, state, mesh=mesh, placement=placement)
        say(f"resumed from step {start}")
    if mesh is not None:
        say(f"mesh {mesh.shape} over {mesh.backend}, {mesh.axis_size(mesh.axis_names)} ranks")

    t_last = time.monotonic()

    def step_fn(state, step):
        nonlocal t_last
        b = ds.batch(step)
        batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        p, o, m = train_step(state["params"], state["opt"], batch)
        if step % 10 == 0:
            sync(device)
            dt = time.monotonic() - t_last
            t_last = time.monotonic()
            say(f"step {step:5d} loss {float(m['loss']):.4f} "
                f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} ({dt:.2f}s/10)")
        return {"params": p, "opt": o}

    loop = ResilientLoop(mgr, straggler=StragglerPolicy())
    state, end = loop.run(state, step_fn, start_step=start, num_steps=args.steps - start)
    mgr.maybe_save(end, state, force=True)
    mgr.wait()
    say(f"done at step {end}; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
