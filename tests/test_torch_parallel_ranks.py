"""The port on serving meshes of one and two ranks, spawned and joined over
gloo on the CPU (``_torch_parallel_worker``), held to its own meshless path
on the same rank: float32 throughout, tolerance 1e-5 where partial sums
over K slices add in another order (ROADMAP caveat 1: tp > 1 is held to the
port's meshless path, not to the reference's (1, 1) bit-identity claim).

World 1 ((1, 1)) must be bit for bit the meshless path.  World 2 runs the
(1, 2) and the (2, 1) mesh: K-sharded linears (W4 and W4A4), the MoE layer
under its tp-only, all-to-all and replicated-token strategies, dispatch ->
combine, the quantized all-gather against the JAX package's wire bytes,
reduced llama and dbrx through ``Engine.generate`` / ``Engine.serve``
(vanilla and with a bf16 speculative draft), and the serve launcher.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from _torch_parallel_worker import run_world
from repro.parallel import collectives as jax_coll

TOL = 1e-5  # f32 partial sums over K slices, added in another order

# label -> (job, kwargs); the ranks run them in this order
WORLD2_JOBS = {
    "qlinear_tp2_w4": ("qlinear", dict(ep=1, tp=2)),
    "qlinear_tp2_w4a4": ("qlinear", dict(ep=1, tp=2, policy="w4a4")),
    "qlinear_tp2_k48": ("qlinear", dict(ep=1, tp=2, k=48)),  # K % (tp * 16) != 0: replicated
    "qlinear_ep2": ("qlinear", dict(ep=2, tp=1)),
    "moe_1x2_t6": ("moe", dict(ep=1, tp=2, tokens=6)),
    "moe_2x1_t6": ("moe", dict(ep=2, tp=1, tokens=6)),
    "moe_2x1_t5": ("moe", dict(ep=2, tp=1, tokens=5)),
    "dispatch_roundtrip": ("dispatch_roundtrip", dict(ep=2)),
    "quantized_all_gather": ("quantized_all_gather", dict(ep=2)),
    "llama_1x2_w4": ("engine", dict(ep=1, tp=2, arch="llama3_2_3b", speculate=True)),
    "llama_1x2_w4a4": ("engine", dict(ep=1, tp=2, arch="llama3_2_3b", policy="w4a4", serve=False)),
    "dbrx_1x2": ("engine", dict(ep=1, tp=2, arch="dbrx_132b")),
    "dbrx_2x1": ("engine", dict(ep=2, tp=1, arch="dbrx_132b", speculate=True)),
    "serve_cli": ("serve_cli", dict(argv=["--arch", "llama3_2_3b", "--reduced", "--packed", "--kv-quant",
                                                "--tp", "2", "--backend", "gloo", "--device", "cpu",
                                                "--max-new", "3", "--continuous"])),
}
WORLD1_JOBS = {
    "llama_1x1_w4": ("engine", dict(ep=1, tp=1, arch="llama3_2_3b", speculate=True)),
    "llama_1x1_w4a4": ("engine", dict(ep=1, tp=1, arch="llama3_2_3b", policy="w4a4")),
    "moe_1x1_t5": ("moe", dict(ep=1, tp=1, tokens=5)),  # 5 tokens: 1 dispatch group with and without the mesh
    "qlinear_1x1": ("qlinear", dict(ep=1, tp=1)),
    "serve_cli": ("serve_cli", dict(argv=["--arch", "llama3_2_3b", "--reduced", "--packed", "--kv-quant",
                                                "--tp", "1", "--ep", "1", "--backend", "gloo", "--device", "cpu",
                                                "--max-new", "3", "--continuous"])),
}


def _world(n, jobs, tmp):
    """{label: [rank 0's result, rank 1's, ...]}"""
    per_rank = run_world(n, list(jobs.values()), tmp)
    return {label: [rank[i] for rank in per_rank] for i, label in enumerate(jobs)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(2, WORLD2_JOBS, tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(1, WORLD1_JOBS, tmp_path_factory.mktemp("world1"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("policy", ["w4", "w4a4"])
def test_qlinear_tp2_matches_meshless(world2, policy):
    for r in world2[f"qlinear_tp2_{policy}"]:
        assert r["k_shards"] == 2 and r["local_shape"] == (64, 96)
        _close(r["got"], r["ref"])


def test_qlinear_indivisible_k_and_ep_axis_replicate(world2):
    for r in world2["qlinear_tp2_k48"] + world2["qlinear_ep2"]:
        assert r["k_shards"] == 1
        np.testing.assert_array_equal(r["got"], r["ref"])


@pytest.mark.parametrize("ep, tp, tokens, strategy", [(1, 2, 6, "tp_only"), (2, 1, 6, "all_to_all"),
                                                      (2, 1, 5, "replicated_tokens")])
def test_moe_forward_strategies_match_meshless(world2, ep, tp, tokens, strategy):
    """Each token strategy runs (its collectives are counted) and equals the
    meshless forward; no capacity drops (factor 8), so the mesh's group
    count (gcd(t, ep), 1 under tp only) does not change the result."""
    for r in world2[f"moe_{ep}x{tp}_t{tokens}"]:
        c = r["calls"]
        assert r["shards"] == (ep, tp)
        assert r["groups"] == np.gcd(tokens, ep)
        if strategy == "all_to_all":
            assert c["dispatch_to_expert_shards"] == c["combine_from_expert_shards"] == 1
        else:
            assert c["dispatch_to_expert_shards"] == 0
        assert c["all_gather_first"] == (0 if strategy == "tp_only" else 1)
        assert c["all_gather_last"] == (1 if tp > 1 else 0)
        _close(r["got"], r["ref"])
        assert r["aux"] == r["aux_ref"]


def test_dispatch_combine_round_trip(world2):
    for r in world2["dispatch_roundtrip"]:
        np.testing.assert_array_equal(r["dispatched"], r["want"])
        np.testing.assert_array_equal(r["back"], r["mine"])


def test_quantized_all_gather_equals_reference_wire(world2):
    """Both ranks hold the quantize-dequantize of the concatenated shards,
    as the JAX package's wire_encode / wire_decode give it."""
    ranks = world2["quantized_all_gather"]
    full = np.concatenate([r["x"] for r in ranks], axis=0)
    codes, meta, shape = jax_coll.wire_encode(jnp.asarray(full))
    want = np.asarray(jax_coll.wire_decode(codes, meta, shape, dtype=jnp.float32))
    for r in ranks:
        np.testing.assert_array_equal(r["got"], want)
    np.testing.assert_array_equal(np.concatenate([r["codes"] for r in ranks]), np.asarray(codes))
    np.testing.assert_array_equal(np.concatenate([r["meta"] for r in ranks]), np.asarray(meta))


def _check_engine(ranks, exact=False):
    for r in ranks:
        tol = 0 if exact else TOL
        _close(r["got"]["prefill_logits"], r["ref"]["prefill_logits"], tol)
        for key in r["ref"]:
            if key != "prefill_logits":
                assert r["got"][key] == r["ref"][key], key
    for r in ranks[1:]:  # every rank, the same logits and tokens
        np.testing.assert_array_equal(r["got"]["prefill_logits"], ranks[0]["got"]["prefill_logits"])
        assert {k: v for k, v in r["got"].items() if k != "prefill_logits"} == \
            {k: v for k, v in ranks[0]["got"].items() if k != "prefill_logits"}


@pytest.mark.parametrize("policy", ["w4", "w4a4"])
def test_llama_engine_tp2_matches_meshless(world2, policy):
    ranks = world2[f"llama_1x2_{policy}"]
    # every packed linear of the reduced llama (d 64, f 256) K-shards at tp 2
    assert ranks[0]["shards"] and all(s[2] == 2 for s in ranks[0]["shards"])
    _check_engine(ranks)


@pytest.mark.parametrize("ep, tp", [(1, 2), (2, 1)])
def test_dbrx_engine_matches_meshless(world2, ep, tp):
    ranks = world2[f"dbrx_{ep}x{tp}"]
    banks = [s for s in ranks[0]["shards"] if s[0] == "PackedStackedTensor"]
    assert banks and all(s[1:3] == (ep, tp) for s in banks)
    _check_engine(ranks)


def test_serve_cli_tp2_equals_one_rank(world1, world2):
    (one,) = world1["serve_cli"]
    for r in world2["serve_cli"]:
        assert [list(o) for o in r] == [list(o) for o in one]


def test_world1_mesh_is_bit_exact(world1):
    """A (1, 1) mesh takes the unsharded path: logits, generate, serve and
    speculative serve equal the meshless engine bit for bit, and so does the
    MoE layer and the linear."""
    for policy in ("w4", "w4a4"):
        ranks = world1[f"llama_1x1_{policy}"]
        assert all(s[2] == 1 for s in ranks[0]["shards"])
        _check_engine(ranks, exact=True)
    for label in ("moe_1x1_t5", "qlinear_1x1"):
        (r,) = world1[label]
        np.testing.assert_array_equal(r["got"], r["ref"])
