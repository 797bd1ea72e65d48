"""Training launcher of the port (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch llama3_2_3b --reduced --device cpu \\
        --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/run1
    python -m repro_torch.launch.train --arch llama3_2_3b --steps 20 --batch 1 --seq 4096 --qat

Random weights from seed 0 (``init_params``), AdamW with a cosine schedule,
the synthetic Markov data of ``train.data``; ``--qat`` trains under RaZeR
fake-quant with a straight-through estimator.  Every 10 steps it prints the
loss, learning rate, gradient norm and seconds; checkpoints go to
``--ckpt-dir`` (the reference's layout, which ``launch.serve --ckpt`` of
either package reads) every ``--ckpt-every`` steps and at the end, and a
restart resumes from the newest.  Meshless: ``--mesh`` other than none
raises (sharded training waits for a mesh with one rank per card).
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
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"],
                    help="the reference's production mesh binding; the port trains meshless ('none')")
    ap.add_argument("--qat", action="store_true", help="RaZeR fake-quant QAT forward (straight-through estimator)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh != "none":
        ap.error("--mesh: the port trains meshless; sharded training waits for a mesh with one rank per card")
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.device import resolve_device, sync
    from repro_torch.models.transformer import init_params
    from repro_torch.train.checkpoint import CheckpointManager, latest_step, restore_checkpoint
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.fault import ResilientLoop, StragglerPolicy
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.trainstep import make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    quant = QuantPolicy.fakequant(ste=True) if args.qat else QuantPolicy.bf16()
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    train_step = make_train_step(cfg, None, ocfg, quant, args.microbatch)

    params = init_params(cfg, seed=0, device=device)
    state = {"params": params, "opt": init_opt_state(params)}
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"razer_{args.arch}_ckpt")
    mgr = CheckpointManager(ckpt_dir, every=args.ckpt_every)
    start = latest_step(ckpt_dir) or 0
    if start:
        state, start = restore_checkpoint(ckpt_dir, state)
        print(f"resumed from step {start}")

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
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} ({dt:.2f}s/10)")
        return {"params": p, "opt": o}

    loop = ResilientLoop(mgr, straggler=StragglerPolicy())
    state, end = loop.run(state, step_fn, start_step=start, num_steps=args.steps - start)
    mgr.maybe_save(end, state, force=True)
    mgr.wait()
    print(f"done at step {end}; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
