"""The JAX package under its (2, 2) ep x tp mesh on four forced host devices,
run as a script by ``tests/test_torch_parallel_mesh4.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_parallel_jax_ref.py OUT_DIR

It writes, for the port's world-4 run to load: the packed-MoE layer's dense
weights and tokens (``moe_params.pkl``, ``moe_x.npy``), the reduced dbrx
weights (``dbrx_params.pkl``), and what the JAX package computes on the
mesh (``jax_out.pkl``): the layer's ``moe_forward`` output (and, off the
mesh, its meshless output) and the reduced dbrx ``Engine.generate`` tokens,
in float32.  The mesh has Auto axes: the reference's sharding code predates
JAX's Explicit default for ``make_mesh``, under which its moe_forward and
Engine do not trace.
"""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core.policy import QuantPolicy
from repro.models import moe as moe_mod
from repro.models import transformer as tf
from repro.models.config import ArchConfig
from repro.parallel.sharding import param_sharding_tree, sharding_ctx
from repro.serving.engine import Engine, ServeConfig, pack_model_weights

PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12], [20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30], [5, 6, 7, 8]]
MOE_CFG = dict(name="t", family="moe", num_layers=1, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
               d_ff=128, vocab_size=64, moe=True, n_experts=4, topk=2, moe_d_ff=64, capacity_factor=8.0,
               compute_dtype="float32")
MOE_TOKENS = 6  # 1 x 6 tokens: 2 dispatch groups on the (2, 2) mesh, the all-to-all strategy


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def main(out: str) -> None:
    assert len(jax.devices()) >= 4, "set XLA_FLAGS=--xla_force_host_platform_device_count=4"
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    res = {}

    cfg = ArchConfig(**MOE_CFG)
    p = moe_mod.moe_init(jax.random.PRNGKey(3), cfg)
    x = np.random.default_rng(4).standard_normal((1, MOE_TOKENS, cfg.d_model)).astype(np.float32)
    packed = pack_model_weights({"layers_0": {"moe": p}}, cfg, QuantPolicy.packed())["layers_0"]["moe"]
    placed = jax.device_put({"m": packed}, param_sharding_tree({"m": packed}, mesh, scan_stacked_prefixes=()))["m"]
    with sharding_ctx(mesh):
        # jitted: the same shard_map program, compiled once instead of op by op
        y = jax.jit(lambda x_, p_: moe_mod.moe_forward(x_, p_, cfg, quant=QuantPolicy.packed())[0])(
            jnp.asarray(x), placed)
    y_ref, _ = moe_mod.moe_forward(jnp.asarray(x), packed, cfg, quant=QuantPolicy.packed())
    res["moe_mesh"], res["moe_meshless"] = np.asarray(y), np.asarray(y_ref)
    with open(f"{out}/moe_params.pkl", "wb") as f:
        pickle.dump(_numpy(p), f)
    np.save(f"{out}/moe_x.npy", x)

    dcfg = dataclasses.replace(get_config("dbrx_132b").reduced(), compute_dtype="float32")
    params = tf.init_params(jax.random.PRNGKey(0), dcfg)
    scfg = ServeConfig(max_len=64, max_new_tokens=4, quant=QuantPolicy.packed(kv_quant=True))
    res["dbrx_mesh"] = Engine(params, dcfg, scfg, mesh=mesh).generate(PROMPTS)
    with open(f"{out}/dbrx_params.pkl", "wb") as f:
        pickle.dump(_numpy(params), f)
    with open(f"{out}/jax_out.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
