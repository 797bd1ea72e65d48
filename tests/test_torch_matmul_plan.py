"""The packed GEMM's launch geometry (``razer_matmul.launch_plan``), on the CPU.

K1, K6, K7 and K8 launch one kernel whose split of K must depend on the
weight's (N, K) alone: that is what keeps a row's bits independent of the
batch and an expert's bits equal to K1's.  These tests hold the pure Python
plan to that, to the grid's and the cluster's limits, and to the CUDA
tile's constants, at every packed shape of the full-width configurations.
"""
import pathlib
import re

import pytest

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.razer_matmul import BK, BN, GRID_Z, MAX_SPLITS, TOKEN_TILES, launch_plan

TILE_HEADER = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "razer_matmul_tile.cuh"


def _packed_shapes():
    """(name, E, K, N) of every packed GEMM of every full-width config of
    the port (``ARCHS``: llama3_2_3b, dbrx_132b and the six dense models of
    the paper's evaluation), meshless and as tp 2 K-shards (local K = K /
    2), with dbrx's banks on E 16 and on the (2, *) mesh's E 8."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        d, q, kv = cfg.d_model, cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd
        linears = [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d)]
        if cfg.n_experts:
            f = cfg.moe_d_ff
            banks = [("gate", d, f), ("up", d, f), ("down", f, d)]
            out += [(f"{arch}:{n}:E{e}", e, k, nn) for n, k, nn in banks for e in (cfg.n_experts, cfg.n_experts // 2)]
            out += [(f"{arch}:{n}:E{cfg.n_experts}:tp2", cfg.n_experts, k // 2, nn) for n, k, nn in banks]
        else:
            linears += [("gate", d, cfg.d_ff), ("up", d, cfg.d_ff), ("down", cfg.d_ff, d)]
        out += [(f"{arch}:{n}", 1, k, nn) for n, k, nn in linears]
        out += [(f"{arch}:{n}:tp2", 1, k // 2, nn) for n, k, nn in linears]
    return out


SHAPES = _packed_shapes()
M_VALUES = (1, 4, 7, 8, 9, 24, 48, 64, 65, 128, 129, 257, 4096)


def test_shapes_cover_the_tp2_local_ks():
    assert {k for name, _, k, _ in SHAPES if name.endswith("tp2")} == {
        1536, 4096, 3072, 5376,  # llama3_2_3b, dbrx_132b
        2048, 7168, 5504, 6144, 6720,  # d_model 4096; d_ff 14336, 11008, 12288, 13440
        2560, 12800, 3584, 9600}  # qwen3_32b (d 5120, f 25600), deepseek_coder_33b (d 7168, f 19200)


@pytest.mark.parametrize("name,e,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_split_depends_on_n_and_k_only(name, e, k, n):
    """Tile width, split count, steps per split and cluster size are the
    same for every M and E: a row sums its K in one grouping at any batch,
    and an expert in K1's."""
    ref = launch_plan(1, 1, n, k)
    for m in M_VALUES:
        for ee in {1, e}:
            plan = launch_plan(ee, m, n, k)
            assert (plan.bn, plan.splits, plan.k_tiles_per_split, plan.cluster) == \
                (ref.bn, ref.splits, ref.k_tiles_per_split, ref.cluster), (m, ee)


@pytest.mark.parametrize("name,e,k,n", SHAPES, ids=[s[0] for s in SHAPES])
def test_no_empty_split_and_within_limits(name, e, k, n):
    """Every split has at least one 64-deep step and together they cover K;
    the cluster is the split group (at most the portable 8); the grid's y
    and z stay within CUDA's 65535 and z is whole clusters."""
    k_tiles = k // BK
    for m in M_VALUES:
        plan = launch_plan(e, m, n, k)
        assert 1 <= plan.splits <= MAX_SPLITS
        assert (plan.splits - 1) * plan.k_tiles_per_split < k_tiles <= plan.splits * plan.k_tiles_per_split
        assert plan.cluster == (plan.splits if plan.splits > 1 else 1)
        gx, gy, gz = plan.grid
        assert gx == -(-n // plan.bn) and gx * plan.bn >= n
        assert gy * plan.nt >= m and gy <= GRID_Z
        assert gz == e * plan.splits and gz <= GRID_Z and gz % plan.cluster == 0


@pytest.mark.parametrize("m", M_VALUES)
def test_token_tile_is_the_smallest_that_holds_m(m):
    """M pads to the next instruction width, not to 64 (decode pads 4 rows
    to 8); beyond 128 tokens a block takes 128 and the grid's y the rest."""
    plan = launch_plan(1, m, 3072, 3072)
    assert plan.nt in TOKEN_TILES
    if m <= TOKEN_TILES[-1]:
        assert plan.nt == min(t for t in TOKEN_TILES if t >= m)
    else:
        assert plan.nt == TOKEN_TILES[-1] and plan.grid[1] == -(-m // TOKEN_TILES[-1])


def test_decode_shapes_fill_the_card():
    """At decode the split brings every full-width llama linear to at least
    one block per SM of an H100 (132), capped by the cluster size."""
    for name, e, k, n in SHAPES:
        plan = launch_plan(e, 4, n, k)
        blocks = plan.grid[0] * plan.grid[2]
        assert blocks >= 132 or plan.splits == MAX_SPLITS or plan.splits == k // BK, (name, plan)


@pytest.mark.parametrize("e,m,n,k", [(1, 4, 64, 32), (1, 4, 64, 96), (1, 0, 64, 64), (0, 4, 64, 64),
                                     (1, 4, 0, 64), (65536, 4, 64, 64 * 64)])
def test_plan_refuses_what_the_kernel_does_not_take(e, m, n, k):
    with pytest.raises(ValueError):
        launch_plan(e, m, n, k)


def test_python_copies_match_the_cuda_tile():
    """BN, BK, MAX_SPLITS and the token tiles are the CUDA constants and the
    launch's instruction widths."""
    src = TILE_HEADER.read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["BN"], const["BK"], const["MAX_SPLITS"]) == (BN, BK, MAX_SPLITS)
    cases = tuple(int(c) for c in re.findall(r"case (\d+): return launch_nt<Tag, \1>", src))
    assert cases == TOKEN_TILES
    specialised = tuple(int(c) for c in re.findall(r"struct Wgmma<(\d+)> \{", src))
    assert specialised == TOKEN_TILES
