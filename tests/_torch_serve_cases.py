"""Shared setup for the serve tests: one reduced config (``ARCHS``: by
default ``llama3_2_3b`` with ``num_kv_heads=2``; reduced ``dbrx_132b``, and a
variant of it with a leading dense layer and a shared expert; float32
compute) served by the JAX package's ``Engine`` and by the port's, from the
same weights (``init_params(PRNGKey(0))`` carried over by ``bridge``), under
the packed W4 + RaZeR-KV policy or the W4A4 + KV policy.

In float32 the two packages do the same arithmetic up to summation order
(the engine tests find logits within 3e-7 and identical KV bytes), so their greedy
tokens, their ``ServeReport`` counters and, under a ``FakeClock``, their
latency lists must be identical.  The engines are cached per policy and
config, so a test file compiles the JAX engine's shapes once.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.core.policy import QuantPolicy as JaxPolicy
from repro.core.policy import TensorSpec as JaxSpec
from repro.models import transformer as jax_tf
from repro.obs import FakeClock as JaxFakeClock
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.pagepool import PagePoolConfig as JaxPoolConfig
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import SchedulerConfig as JaxSchedConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.policy import QuantPolicy, TensorSpec
from repro_torch.obs import FakeClock
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.pagepool import PagePoolConfig
from repro_torch.serving.scheduler import Request, SchedulerConfig

MAX_LEN = 64
N_NEW = 8
SHARED = [7, 3, 9, 4, 2, 8, 6, 1]  # two full pages at page size 4
COUNTERS = ("decode_steps", "prefill_tokens", "cached_tokens", "peak_pages", "peak_slots",
            "drafted_tokens", "accepted_drafts", "draft_steps", "cache_lookups", "cache_hits",
            "cache_evictions", "new_tokens")


# name -> (config module, fields replaced in both packages' reduced config)
ARCHS = {
    "llama3_2_3b": ("llama3_2_3b", dict(num_kv_heads=2)),
    "dbrx": ("dbrx_132b", {}),
    # two layer groups: a dense layer, then an MoE layer with a shared
    # expert; the dense MLP gets the shared expert's width, so that the JAX
    # package's eager packing compiles for fewer weight shapes
    "dbrx_fd1s1": ("dbrx_132b", dict(num_layers=2, first_dense_layers=1, n_shared_experts=1, d_ff=128)),
}


def configs(arch: str = "llama3_2_3b"):
    name, kw = ARCHS[arch]
    jcfg = dataclasses.replace(get_config(name).reduced(), compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(torch_get_config(name).reduced(), compute_dtype="float32", **kw)
    return jcfg, tcfg


def policies(name: str):
    jp, tp = JaxPolicy.packed(kv_quant=True), QuantPolicy.packed(kv_quant=True)
    if name == "w4a4_kv":
        jp = JaxPolicy(weight=jp.weight, act=JaxSpec.act("razer"), kv=jp.kv, rules=jp.rules)
        tp = QuantPolicy(weight=tp.weight, act=TensorSpec.act("razer"), kv=tp.kv, rules=tp.rules)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str = "llama3_2_3b"):
    jcfg, _ = configs(arch)
    return jax_tf.init_params(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def port_engine(policy: str = "w4_kv", arch: str = "llama3_2_3b") -> Engine:
    """The port's engine on the JAX package's weights; cached per policy and config."""
    torch.set_num_threads(2)
    _, tcfg = configs(arch)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, _jax_params(arch)), device="cpu")
    return Engine(tparams, tcfg, ServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW, quant=policies(policy)[1]),
                  device="cpu")


@functools.lru_cache(maxsize=None)
def engines(policy: str = "w4_kv", arch: str = "llama3_2_3b"):
    """(JAX engine, port engine) on the same weights; cached per policy and config."""
    jcfg, _ = configs(arch)
    je = JaxEngine(_jax_params(arch), jcfg, JaxServeConfig(max_len=MAX_LEN, max_new_tokens=N_NEW,
                                                           quant=policies(policy)[0]))
    return je, port_engine(policy, arch)


def prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).tolist() for n in sizes]


def requests(specs, port: bool):
    """Fresh Request objects (serve mutates them) from (prompt, max_new,
    arrival, eos_id) tuples, for the port or for the JAX package."""
    cls = Request if port else JaxRequest
    return [cls(rid=i, prompt=list(p), max_new_tokens=n, arrival=a, eos_id=e)
            for i, (p, n, a, e) in enumerate(specs)]


def serve_both(specs, *, policy="w4_kv", arch="llama3_2_3b", ps=None, num_pages=None, slots=None,
               budget=None, tick=None, **kw):
    """Serve the same request stream through both engines; ``ps`` /
    ``num_pages`` size the pool (default: the engine's), ``slots`` /
    ``budget`` the scheduler, and ``tick`` runs both on a FakeClock."""
    je, te = engines(policy, arch)
    out = []
    for eng, port in ((je, False), (te, True)):
        args = dict(kw)
        if ps is not None:
            cls = PagePoolConfig if port else JaxPoolConfig
            args["pool_cfg"] = cls(num_pages=num_pages or 48, page_size=ps, max_len=MAX_LEN)
        if slots is not None or budget is not None:
            cls = SchedulerConfig if port else JaxSchedConfig
            args["sched_cfg"] = cls(max_slots=slots or 8, prefill_token_budget=budget or 512)
        if tick is not None:
            args["clock"] = (FakeClock if port else JaxFakeClock)(tick=tick)
        out.append(eng.serve(requests(specs, port), **args))
    return out


def assert_same_report(jrep, trep, clocked: bool = False):
    """Identical greedy tokens and counters; under a FakeClock also the
    per-request TTFT and latency lists."""
    assert trep.outputs == jrep.outputs
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    if clocked:
        assert trep.ttft_values() == jrep.ttft_values()
        assert trep.latency_values() == jrep.latency_values()
        assert trep.wall_time == jrep.wall_time
        assert trep.ttft_p95 == jrep.ttft_p95
