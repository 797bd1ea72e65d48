"""Where a W4A4 QAT step on a mesh parts from the meshless step: the
activation fake-quant's (K2's) blocks whose E4M3 scale differs between the
two runs, counted, and then pinned.

    python3 tools/mesh_w4a4_flips.py [--extra 3] [--out FILE]

The cell is ``chip_smoke.py`` phase 12 (f) (b)'s: llama3_2_3b at full width
cut to ``MESH_TRAIN_RANK_LAYERS`` layers, f32 compute,
``MESH_TRAIN_RANK_TOKENS`` a step, seed-0 weights, on the (1, 2) and (2, 1)
meshes of two gloo ranks sharing the card.  Each rank runs the phase's
first three steps (2 bf16, 1 weight QAT) meshless and on the mesh, which
reach the parameters P_ref and P_mesh, and then the W4A4 step:

  * ``smoke``: on the mesh from P_mesh against meshless from P_ref, the
    phase's own comparison, on the phase's fourth batch;
  * ``same_params``: on the mesh from P_ref placed on it, so that only the
    order of the sums differs;
  * ``extra``: as ``smoke`` on ``--extra`` more batches (the spread of the
    difference).

The meshless W4A4 step records every K2 call (input and output; 2 x 7 a
layer, the forward and remat's recompute).  On the mesh each K2 call is
held against the same call's record, on the rank's own rows and columns
of it: the 16-element blocks compared, those whose scale differs, and
those whose scale is the same but whose output differs (an element on a
rounding boundary of the FP4 grid).  In mode ``pin_scale`` the mesh's K2
output takes the meshless output in the blocks whose scale differs, in
``pin_all`` in every block whose output differs; ``plain`` changes
nothing.  Each row: the loss and gradient norm, their difference relative
to the meshless step's, the block counts, and (``smoke`` and ``extra``,
mode ``plain``) the parameters after the step gathered whole against the
meshless step's: the largest difference and the share above 1e-6.

Prints the card's name and power limit and one JSON line; exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import pickle
import sys
import tempfile
import time
import traceback

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LAYOUTS = ((1, 2), (2, 1))
DEVICE = "cuda"  # both ranks on its first card


class K2Probe:
    """Wraps ``core.qlinear.qdq_spec`` (K2 on the card): records the calls
    of a meshless step, or holds a mesh step's calls against them."""

    def __init__(self, real):
        self.real, self.mode, self.ref, self.i = real, None, [], 0
        self.counts = {}
        self.data_index = self.model_index = 0

    def start(self, mode, mesh=None):
        self.mode, self.i = mode, 0
        self.counts = {"calls": 0, "blocks": 0, "scale_differs": 0, "output_differs_same_scale": 0,
                       "pinned": 0}
        if mode == "record":
            self.ref = []
        if mesh is not None:
            self.data_index, self.model_index = mesh.data_index, mesh.model_index

    def _view(self, t, like):
        """The rows and columns of a meshless (B, S, K) record that this
        rank's (b, S, k) call sees: its data shard's rows, its model
        shard's columns."""
        if t.shape[0] != like.shape[0]:
            n = like.shape[0]
            t = t[self.data_index * n:(self.data_index + 1) * n]
        if t.shape[-1] != like.shape[-1]:
            k = like.shape[-1]
            t = t[..., self.model_index * k:(self.model_index + 1) * k]
        assert t.shape == like.shape, (tuple(t.shape), tuple(like.shape))
        return t

    def __call__(self, x, spec):
        from repro_torch.core.formats import FP4_MAX
        from repro_torch.core.nvfp4 import _block_scales

        y = self.real(x, spec)
        if self.mode == "record":
            self.ref.append((x.detach().clone(), y.detach().clone()))
        elif self.mode is not None:
            xr, yr = (self._view(t, x) for t in self.ref[self.i])
            self.i += 1

            def blocks(t):
                return t.float().reshape(*t.shape[:-1], t.shape[-1] // 16, 16)

            one = torch.ones((), device=x.device)  # K2 has no tensor scale
            scale_differs = (_block_scales(blocks(x), "e4m3", FP4_MAX, one)
                             != _block_scales(blocks(xr), "e4m3", FP4_MAX, one))
            out_differs = (blocks(y) != blocks(yr)).any(-1)
            c = self.counts
            c["calls"] += 1
            c["blocks"] += scale_differs.numel()
            c["scale_differs"] += int(scale_differs.sum())
            c["output_differs_same_scale"] += int((out_differs & ~scale_differs).sum())
            pin = {"pin_scale": scale_differs, "pin_all": out_differs}.get(self.mode)
            if pin is not None:
                c["pinned"] += int(pin.sum())
                y = torch.where(pin[..., None], blocks(yr), blocks(y)).reshape(y.shape).to(y.dtype)
        return y


def _rel(a, b):
    return abs(a - b) / abs(b)


def _rank(rank, world, init, extra):
    import dataclasses
    import importlib

    import chip_smoke as cs
    from repro_torch.bridge import gather_tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel.sharding import local_tree
    from repro_torch.train.trainstep import bind_train_step
    from repro_torch.train.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    qlinear = importlib.import_module("repro_torch.core.qlinear")  # the package exports a function of that name
    probe = K2Probe(qlinear.qdq_spec)
    qlinear.qdq_spec = probe
    full = get_config("llama3_2_3b")
    cfg = dataclasses.replace(full, num_layers=cs.MESH_TRAIN_RANK_LAYERS, compute_dtype="float32")
    b, s = cs.MESH_TRAIN_RANK_TOKENS
    batches = cs._train_batches(cfg, 4 + extra, b, s)
    dev = torch.device(DEVICE, 0)
    clone = lambda tree: tree_map(torch.clone, tree)  # noqa: E731 (the step updates in place)

    def w4a4(mesh, params, opt, batch):
        """The W4A4 step (the fourth of ``_mesh_train_policies``) on
        ``batch``: (params after it, its row)."""
        p, _, rows = cs._mesh_train_run(cfg, mesh, params, opt, batches[:3] + [batch], True, dev, counted=False,
                                        first=3)
        return p, rows[0]

    out = {}
    whole = init_params(cfg, seed=0, device=dev)
    p_ref, o_ref, _ = cs._mesh_train_run(cfg, None, clone(whole), None, batches[:3], False, dev, counted=False)
    for layout in LAYOUTS:
        mesh = make_test_mesh(layout, backend="gloo", device=DEVICE, init_method=f"file://{init}", rank=rank,
                              world_size=world)
        p_shard = bind_train_step(cfg, mesh, None)[1]
        p_mesh, o_mesh, _ = cs._mesh_train_run(cfg, mesh, local_tree(whole, p_shard, mesh), None, batches[:3], False,
                                               dev, counted=False)
        cases = [("smoke", 3, ("plain", "pin_scale", "pin_all"))] + [("same_params", 3, ("plain", "pin_scale"))] \
            + [(f"extra_{i}", 4 + i, ("plain",)) for i in range(extra)]
        rows = {}
        for name, bi, modes in cases:
            t0 = time.perf_counter()
            probe.start("record")
            after_ref, ref = w4a4(None, clone(p_ref), clone(o_ref), batches[bi])
            probe.start(None)
            row = {"batch": bi, "meshless": {"loss": ref["loss"], "grad_norm": ref["grad_norm"]}}
            for mode in modes:
                if name == "same_params":  # the moments do not reach the loss or the gradient norm
                    start_p, start_o = local_tree(p_ref, p_shard, mesh), None
                else:
                    start_p, start_o = clone(p_mesh), clone(o_mesh)
                probe.start(mode, mesh)
                after, got = w4a4(mesh, start_p, start_o, batches[bi])
                counts = probe.counts
                probe.start(None)
                r = {"loss": got["loss"], "grad_norm": got["grad_norm"], "loss_rel": _rel(got["loss"], ref["loss"]),
                     "grad_norm_rel": _rel(got["grad_norm"], ref["grad_norm"]), "k2": counts}
                if mode == "plain" and name != "same_params":
                    with torch.no_grad():
                        gathered = gather_tree(after, p_shard, mesh)
                    diffs = torch.cat([(a - c).abs().flatten() for a, c in zip(tree_leaves(gathered),
                                                                                tree_leaves(after_ref))])
                    r["param_diff"] = {"max_abs": float(diffs.max()),
                                       "share_beyond_1e-6": float((diffs > 1e-6).float().mean())}
                    del gathered, diffs
                row[mode] = r
                del after
            row["seconds"] = time.perf_counter() - t0
            rows[name] = row
            del after_ref
            torch.cuda.empty_cache()
        out[f"mesh_{layout[0]}x{layout[1]}"] = rows
        del p_mesh, o_mesh
        torch.cuda.empty_cache()
    return out


def _entry(rank, world, init, out_dir, extra):
    import torch.distributed as dist

    try:
        result = _rank(rank, world, init, extra)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--extra", type=int, default=3, help="more batches for the W4A4 step, plain mode only")
    ap.add_argument("--timeout", type=float, default=1500.0, help="seconds the two ranks may take")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args()

    import chip_smoke as cs
    import torch.multiprocessing as mp

    smi = cs._require_cuda()
    print(smi, flush=True)
    from repro_torch.kernels import build

    build.build_all()
    out_dir = tempfile.mkdtemp(prefix="mesh_w4a4_flips_")
    init = os.path.join(out_dir, "pg_init")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, 2, init, out_dir, args.extra)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + args.timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    errs = [open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(2)
            if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if errs or any(p.exitcode != 0 for p in procs):
        print("\n".join(errs), file=sys.stderr)
        return 1
    ranks = [pickle.load(open(os.path.join(out_dir, f"rank{r}.pkl"), "rb")) for r in range(2)]
    for mesh_name, rows in ranks[0].items():
        for name, row in rows.items():
            for mode, r in row.items():
                if isinstance(r, dict) and "loss_rel" in r:
                    other = ranks[1][mesh_name][name][mode]
                    assert (other["loss"], other["grad_norm"]) == (r["loss"], r["grad_norm"]), (mesh_name, name, mode)
                    r["k2_rank1"] = other["k2"]
    res = {"card": smi, "cut": {"num_layers": [28, cs.MESH_TRAIN_RANK_LAYERS]},
           "batch_seq": list(cs.MESH_TRAIN_RANK_TOKENS), "compute_dtype": "float32",
           "seconds": time.perf_counter() - t0, **ranks[0]}
    line = json.dumps(res)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
