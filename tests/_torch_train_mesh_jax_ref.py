"""The JAX package's sharded train step on forced host devices, run as a
script by ``tests/test_torch_train_mesh_steps.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_train_mesh_jax_ref.py OUT_DIR [CASE ...]

Reduced llama3_2_3b in f32, three steps of ``bind_train_step`` (the
reference's own: ``param_sharding_tree`` placement, ``jax.jit`` with its
out shardings) on each case's mesh, from weights drawn with numpy in the
shapes of the JAX package's tree (the norm gains nonzero).  It writes the
weights (``params.pkl``), the global batches
(``batches.pkl``, and ``batches_mask.pkl`` with a mask whose rows differ),
and per case the losses, gradient norms and final parameters, flat as
the checkpoints' keys ("layers_0::mixer::wq", layer groups stacked), in
``jax_out.pkl``: every case of ``CASES``, or those named.  The cases are
traced in turn and compiled concurrently, and the layers run without remat
(``REMAT_POLICY`` "none", the same values) to keep the compiles short.  The mesh has Auto axes: the reference's sharding code
predates JAX's Explicit default for ``make_mesh``.
"""
import concurrent.futures
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core.policy import QuantPolicy
from repro.models import transformer as tf
from repro.train import optimizer as jopt
from repro.train import trainstep as ts
from repro.train.data import DataConfig, SyntheticLM

LR, STEPS, BATCH, SEQ = 1e-4, 3, 4, 16
POLICIES = {"bf16": QuantPolicy.bf16(), "qat_w4": QuantPolicy.fakequant(ste=True),
            "qat_w4a4": QuantPolicy.fakequant(act_format="razer", ste=True)}
# (name, mesh shape, policy, microbatch, batches with the mask); a
# three-dim shape is (pod, data, model)
CASES = (("bf16_mask_mb2_2x2", (2, 2), "bf16", 2, True),
         ("qat_w4_2x1", (2, 1), "qat_w4", 0, False),
         ("qat_w4_1x2", (1, 2), "qat_w4", 0, False),
         ("qat_w4a4_1x2", (1, 2), "qat_w4a4", 0, False),
         ("qat_w4a4_2x2", (2, 2), "qat_w4a4", 0, False),
         ("bf16_pod_2x1x2", (2, 1, 2), "bf16", 0, False))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}::{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def draw_params(cfg, seed: int = 0):
    """Weights in the JAX package's tree: linears N(0, 1 / d_in), the
    embedding 0.02 N(0, 1), norm gains 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape).astype(np.float32)
        if "embed" in name:
            return x * np.float32(0.02)
        if len(s.shape) >= 3 or (len(s.shape) == 2 and not name.startswith("['layers")):
            return x / np.float32(np.sqrt(s.shape[-2]))
        return x * np.float32(0.1)

    shapes = jax.eval_shape(lambda: tf.init_params(jax.random.PRNGKey(0), cfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def batches(mask: bool):
    ds = SyntheticLM(DataConfig(vocab_size=256, seq_len=SEQ, global_batch=BATCH))
    out = [ds.batch(i) for i in range(STEPS)]
    if mask:  # row r keeps its first SEQ - 3 r positions, and step i drops i more
        for i, b in enumerate(out):
            b["mask"] = (np.arange(SEQ)[None, :] < (SEQ - 3 * np.arange(BATCH) - i)[:, None]).astype(np.float32)
    return out


def config():
    return dataclasses.replace(get_config("llama3_2_3b").reduced(), compute_dtype="float32")


def write_inputs(out: str):
    """The weights and batches every side starts from -> (params, {mask:
    batches}); also pickled into ``out``."""
    params = draw_params(config())
    data = {False: batches(False), True: batches(True)}
    with open(f"{out}/params.pkl", "wb") as f:
        pickle.dump(params, f)
    for mask, name in ((False, "batches.pkl"), (True, "batches_mask.pkl")):
        with open(f"{out}/{name}", "wb") as f:
            pickle.dump(data[mask], f)
    return params, data


def main(out: str, names=()) -> None:
    assert len(jax.devices()) >= 4, "set XLA_FLAGS=--xla_force_host_platform_device_count=4"
    tf.REMAT_POLICY.set("none")
    cfg = config()
    params, data = write_inputs(out)
    ocfg = jopt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS)

    def lowered_case(case):
        name, shape, pol, microbatch, mask = case
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(shape),
                             devices=jax.devices()[:int(np.prod(shape))])
        step, p_shard, o_shard = ts.bind_train_step(cfg, mesh, jax.eval_shape(lambda: params), ocfg,
                                                    POLICIES[pol], microbatch, donate=False)
        p = jax.device_put(params, p_shard)
        o = jax.device_put(jopt.init_opt_state(params), o_shard)
        first = {k: jnp.asarray(v) for k, v in data[mask][0].items()}
        return step.lower(p, o, first), p, o

    cases = [c for c in CASES if not names or c[0] in names]
    lowered = [lowered_case(case) for case in cases]
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        runs = list(pool.map(lambda low: low[0].compile(), lowered))
    built = [(run, p, o) for run, (_, p, o) in zip(runs, lowered)]
    res = {}
    for (name, _, _, _, mask), (run, p, o) in zip(cases, built):
        losses, gnorms = [], []
        for b in data[mask]:
            p, o, m = run(p, o, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(np.float32(m["loss"]))
            gnorms.append(np.float32(m["grad_norm"]))
        res[name] = {"losses": losses, "grad_norms": gnorms, "params": flat(jax.tree_util.tree_map(np.asarray, p))}
    with open(f"{out}/jax_out.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
