"""The train mesh's placement and refusals, in process (no ranks): every
leaf's local shape, and the batch's, against ``NamedSharding(mesh,
spec).shard_shape`` of the JAX package's ``param_sharding_tree`` and
``input_sharding`` on an abstract mesh of the same shape (reduced
llama3_2_3b at the test meshes and on every rank, llama3_2_3b at full
width on rank 0 of the production meshes); ``make_train_step`` refusing what it cannot split.
The ranks' steps are ``test_torch_train_mesh_steps.py``'s.
"""
import dataclasses
import itertools

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tf
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import get_config
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import transformer as tf
from repro_torch.parallel.sharding import ServingMesh, input_sharding
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainstep import bind_train_step, make_train_step

MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
PRODUCTION = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def views(shape, axes):
    """A placement-only view of every rank of the mesh (no process group)."""
    sizes = dict(zip(axes, shape))
    for coords in itertools.product(*(range(n) for n in shape)):
        at = dict(zip(axes, coords))
        yield ServingMesh(ep=sizes.get("data", 1), tp=sizes["model"], data_index=at.get("data", 0),
                          model_index=at["model"], device=None, backend="none", pod=sizes.get("pod", 1),
                          pod_index=at.get("pod", 0), axis_names=tuple(axes))


def reference_shapes(jcfg, shape, axes):
    mesh = AbstractMesh(tuple(shape), tuple(axes))
    shapes = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    tree = jax_sharding.param_sharding_tree(shapes, mesh)
    out = {}

    def walk(prefix, sh, leaf):
        if isinstance(sh, dict):
            for k in sh:
                walk(f"{prefix}/{k}" if prefix else k, sh[k], leaf[k])
        else:
            s = NamedSharding(mesh, sh.spec).shard_shape(leaf.shape)
            out[prefix] = tuple(s[1:]) if prefix.startswith("layers_") else tuple(s)

    walk("", tree, shapes)
    return out


def port_shapes(cfg, mesh):
    place = tf.train_placement(cfg, mesh)
    params = tf.init_params(cfg, device="meta")
    out = {}

    def walk(prefix, node, pl):
        if isinstance(node, dict):
            for k in node:
                walk(f"{prefix}/{k}" if prefix else k, node[k], pl[k])
        elif isinstance(node, list):
            for layer, layer_pl in zip(node, pl):
                walk(prefix, layer, layer_pl)
        else:
            local = tuple(pl.local(node, mesh).shape)
            assert out.setdefault(prefix, local) == local
            assert local == pl.shard_shape(node.shape, mesh)

    walk("", params, place)
    return out


@pytest.mark.parametrize("shape, axes", MESHES)
def test_reduced_placement_is_the_references(shape, axes):
    cfg = get_config("llama3_2_3b").reduced()
    want = reference_shapes(jax_get_config("llama3_2_3b").reduced(), shape, axes)
    for mesh in views(shape, axes):
        assert port_shapes(cfg, mesh) == want


@pytest.mark.parametrize("shape, axes", PRODUCTION)
def test_full_width_placement_on_the_production_meshes(shape, axes):
    mesh = next(views(shape, axes))
    want = reference_shapes(jax_get_config("llama3_2_3b"), shape, axes)
    assert port_shapes(get_config("llama3_2_3b"), mesh) == want


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 8])
def test_batch_placement_is_the_references(batch):
    """(pod, data), then data alone, then none, as the batch divides."""
    for shape, axes in MESHES:
        mesh = AbstractMesh(tuple(shape), tuple(axes))
        want = NamedSharding(mesh, jax_sharding.input_sharding(mesh, (batch, 16)).spec).shard_shape((batch, 16))
        for view in views(shape, axes):
            assert input_sharding(view, (batch, 16)).shard_shape((batch, 16), view) == tuple(want), (batch, shape)


def _view(tp, dp=1):
    return next(views((dp, tp), ("data", "model")))


@pytest.mark.parametrize("cfg_kw, tp, policy, match", [
    ({}, 3, "bf16", "query heads"),
    (dict(num_kv_heads=2), 4, "bf16", "KV heads"),
    (dict(d_ff=201), 2, "bf16", "FFN columns"),
    (dict(d_ff=200), 2, "qat_w4a4", "16-element blocks"),
])
def test_make_train_step_refuses_a_mesh_it_cannot_split(cfg_kw, tp, policy, match):
    """Query heads, KV heads and d_ff must split evenly over the model
    axis; under W4A4 each rank's slice of down's input (d_ff / tp = 100
    here) must hold whole 16-element blocks of the activation quantizer,
    which weight-only QAT does not need."""
    cfg = dataclasses.replace(get_config("llama3_2_3b").reduced(), **cfg_kw)
    quant = {"bf16": QuantPolicy.bf16(),
             "qat_w4a4": QuantPolicy.fakequant(act_format="razer", ste=True)}[policy]
    if policy == "qat_w4a4":
        make_train_step(cfg, _view(tp), AdamWConfig(), QuantPolicy.fakequant(ste=True))
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg, _view(tp), AdamWConfig(), quant)


@pytest.mark.parametrize("arch", ["dbrx_132b", "deepseek_v2_236b", "mamba2_370m", "recurrentgemma_2b",
                                  "whisper_base", "qwen2_vl_7b"])
def test_mesh_training_refuses_the_archs_it_does_not_port(arch):
    with pytest.raises(ValueError, match="dense GQA decoders"):
        make_train_step(get_config(arch).reduced(), _view(1, 2))


def test_bind_train_step_returns_the_placements():
    cfg = get_config("llama3_2_3b").reduced()
    mesh = _view(2, 2)
    _, p_shard, o_shard = bind_train_step(cfg, mesh)
    assert p_shard == tf.train_placement(cfg, mesh) and o_shard.m == p_shard and o_shard.v == p_shard
    assert p_shard["layers_0"][0]["mixer"]["wq"].spec == ("data", "model")
    assert p_shard["embed"].spec == ("model", "data") and p_shard["final_norm"].spec == ()
    with pytest.raises(ValueError, match="parameter tree"):
        bind_train_step(cfg, mesh, tf.init_params(get_config("llama3_1_8b").reduced(), device="meta"))
