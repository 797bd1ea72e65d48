"""The port on the (2, 2) ep x tp serving mesh: four spawned gloo ranks on
the CPU, against the port's meshless path (float32, 1e-5) and against the
JAX package under its own (2, 2) mesh, which runs in a subprocess on four
forced host devices (``_torch_parallel_jax_ref.py``) and hands its weights
over as numpy.  The JAX comparisons use the tolerances of
``tests/test_tensor_parallel.py`` (2e-3).

On this mesh the MoE trio splits E/2 x K/2 (the all-to-all strategy at an
even token count, replicated tokens at an odd one), degrades to ep only as
one unit when d does not split into whole blocks per rank, and reduced
llama and dbrx run ``Engine.generate`` and ``Engine.serve``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from _torch_parallel_worker import run_world

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5  # f32 partial sums over K slices, added in another order
JAX_TOL = 2e-3  # tests/test_tensor_parallel.py's, for the JAX package's (2, 2) mesh


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh4")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "_torch_parallel_jax_ref.py"), str(out)],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def world4(jax_ref, tmp_path_factory):
    import pickle

    jobs = {
        "moe_t6": ("moe", dict(ep=2, tp=2, tokens=6)),
        "moe_t5": ("moe", dict(ep=2, tp=2, tokens=5)),
        "moe_d48": ("moe", dict(ep=2, tp=2, tokens=6, cfg_kw=dict(d_model=48, num_heads=3))),
        "moe_jax": ("moe", dict(ep=2, tp=2, tokens=6, params_file=str(jax_ref / "moe_params.pkl"),
                                x_file=str(jax_ref / "moe_x.npy"))),
        "qlinear": ("qlinear", dict(ep=2, tp=2)),
        "llama": ("engine", dict(ep=2, tp=2, arch="llama3_2_3b")),
        "dbrx": ("engine", dict(ep=2, tp=2, arch="dbrx_132b", speculate=True)),
        "dbrx_jax": ("engine", dict(ep=2, tp=2, arch="dbrx_132b", params_file=str(jax_ref / "dbrx_params.pkl"),
                                    serve=False)),
    }
    per_rank = run_world(4, list(jobs.values()), tmp_path_factory.mktemp("world4"))
    with open(jax_ref / "jax_out.pkl", "rb") as f:
        jax_out = pickle.load(f)
    return {label: [rank[i] for rank in per_rank] for i, label in enumerate(jobs)}, jax_out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("label, shards, strategy", [("moe_t6", (2, 2), "all_to_all"),
                                                     ("moe_t5", (2, 2), "replicated_tokens"),
                                                     ("moe_d48", (2, 1), "all_to_all")])
def test_moe_forward_on_2x2_matches_meshless(world4, label, shards, strategy):
    """d = 48 cannot split into whole 16-blocks over tp 2: the trio degrades
    to ep only as one unit (K whole, no tp gather) and still matches."""
    res, _ = world4
    for r in res[label]:
        c = r["calls"]
        assert r["shards"] == shards
        assert (c["dispatch_to_expert_shards"] == 1) == (strategy == "all_to_all")
        assert c["all_gather_first"] == 1 and c["all_gather_last"] == (1 if shards[1] > 1 else 0)
        _close(r["got"], r["ref"])


def test_qlinear_on_2x2_matches_meshless(world4):
    res, _ = world4
    for r in res["qlinear"]:
        assert r["k_shards"] == 2
        _close(r["got"], r["ref"])


@pytest.mark.parametrize("label", ["llama", "dbrx"])
def test_engine_on_2x2_matches_meshless(world4, label):
    res, _ = world4
    ranks = res[label]
    for r in ranks:
        _close(r["got"]["prefill_logits"], r["ref"]["prefill_logits"])
        for key, want in r["ref"].items():
            if key != "prefill_logits":
                assert r["got"][key] == want, key
        assert r["got"]["generate"] == ranks[0]["got"]["generate"]
    if label == "dbrx":
        banks = [s for s in ranks[0]["shards"] if s[0] == "PackedStackedTensor"]
        assert banks and all(s[1:3] == (2, 2) for s in banks)


def test_moe_forward_matches_jax_package_on_2x2(world4):
    """The same packed layer and tokens through the JAX package's (2, 2)
    shard_map path and the port's four gloo ranks."""
    res, jax_out = world4
    _close(jax_out["moe_mesh"], jax_out["moe_meshless"], JAX_TOL)
    for r in res["moe_jax"]:
        assert r["shards"] == (2, 2)
        _close(r["got"], jax_out["moe_mesh"], JAX_TOL)


def test_dbrx_generate_tokens_match_jax_package_on_2x2(world4):
    res, jax_out = world4
    for r in res["dbrx_jax"]:
        assert r["got"]["generate"] == jax_out["dbrx_mesh"]
