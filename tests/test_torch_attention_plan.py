"""The host side of the decode-attention kernels K3, K4 and K5
(``kernels.attention_plan``: the split count and workspace the wrappers
size each call with), and their plain versions against the Pallas kernels
in interpret mode at lengths around a page, a split and several splits.

The kernels run only on a card: ``tests/test_torch_cuda.py`` holds them to
their plain versions, K4 == K3, K5's query t == K4 at its length and a
sequence's output alone == inside a batch.  Here the plan's constants are
held equal to the CUDA body's, and the plain versions the kernels are held
to on the card are held to the reference.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.serving.kvcache import kv_quantize as jax_kv_quantize
from repro_torch.kernels import ops
from repro_torch.kernels.attention_plan import (CHUNK, GROUP, HEAD_DIMS, MAX_G, MAX_ROWS, SPLIT, num_groups,
                                                num_splits, partial_floats, workspace, workspace_size)

torch.set_num_threads(2)
BODY = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "razer_kv_attend.cuh"
PAGE = 16
LENGTHS = [0, 1, 15, 16, 17, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT, 4001, 4096, 32768]
TOL = 1e-5  # f32: the plain versions and the Pallas kernels sum in other orders


@pytest.mark.parametrize("length", LENGTHS)
def test_split_count_covers_the_sequence(length):
    """The host's split count (which sizes the workspace for a table's span)
    cuts [0, L) into page-aligned splits of SPLIT positions, the last one
    non-empty, and groups them GROUP at a time in split order."""
    n = num_splits(length)
    assert (n - 1) * SPLIT < max(length, 1) <= n * SPLIT
    assert SPLIT % PAGE == 0
    g = num_groups(n)
    assert (g - 1) * GROUP < n <= g * GROUP


def test_plan_constants_match_the_cuda_body():
    src = BODY.read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (const["SPLIT"], const["CHUNK"], const["MAX_G"], const["MAX_ROWS"], const["GROUP"]) == \
        (SPLIT, CHUNK, MAX_G, MAX_ROWS, GROUP)
    assert SPLIT % CHUNK == 0 and SPLIT % PAGE == 0 and CHUNK % 16 == 0
    built = re.search(r"constexpr bool built_hd\(int hd\) \{ return ([^;]+);", src).group(1)
    assert tuple(int(v) for v in re.findall(r"hd == (\d+)", built)) == HEAD_DIMS
    assert tuple(int(v) for v in re.findall(r"case (\d+): return f\.template go<\1, NTM>", src)) == HEAD_DIMS
    splits = re.search(r"inline int num_splits\(int len\) \{ return ([^}]+)\}", src).group(1)
    assert splits.strip() == "len > SPLIT ? (len + SPLIT - 1) / SPLIT : 1;"


@pytest.mark.parametrize("rows,hd", [(1, 16), (3, 128), (6, 128), (9, 128), (32, 64), (8, 256)])
def test_partials_stay_16_byte_aligned(rows, hd):
    assert partial_floats(rows, hd) % 4 == 0 and partial_floats(rows, hd) >= rows * (hd + 2)
    assert workspace_size(16, 8, 4096, rows, hd) == (16 * 8 * (16 + 2) * partial_floats(rows, hd), 16 * 8 * 3)
    assert workspace_size(1, 8, 32768, rows, hd) == (8 * (128 + 16) * partial_floats(rows, hd), 8 * 17)


def test_workspace_is_kept_and_grown():
    """One workspace per device, kept between calls, grown when a call
    needs more; its tickets start at zero."""
    dev = torch.device("cpu", 0)
    ws, tickets = workspace(dev, 100, 4)
    assert ws.numel() >= 100 and tickets.numel() >= 4 and int(tickets.abs().sum()) == 0
    again, again_t = workspace(dev, 50, 2)
    assert again is ws and again_t is tickets
    bigger, bigger_t = workspace(dev, ws.numel() + 1, tickets.numel() + 1)
    assert bigger.numel() > ws.numel() and bigger_t.numel() > tickets.numel() and int(bigger_t.sum()) == 0


# --- the plain versions against the Pallas kernels (interpret mode) -------------------------------
def _pool(rng, p, ps, kvh, hd):
    kc, km = jax_kv_quantize(jnp.asarray(rng.standard_normal((p, ps, kvh, hd)), jnp.float32))
    vc, vm = jax_kv_quantize(jnp.asarray(rng.standard_normal((p, ps, kvh, hd)), jnp.float32))
    jcache = {"k_codes": kc, "k_meta": km, "v_codes": vc, "v_meta": vm}
    return jcache, {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}


KVH, G, HD = 2, 3, 64


def _paged_case(seed, lengths, ps=PAGE):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    npg = -(-max(lengths) // ps) + 1
    p = b * npg + 1
    jcache, tcache = _pool(rng, p, ps, KVH, HD)
    pt = rng.permutation(np.arange(1, p)).reshape(b, npg).astype(np.int32)
    return rng, jcache, tcache, pt


@pytest.mark.parametrize("lengths", [[1], [15], [16], [17], [SPLIT - 1], [SPLIT], [SPLIT + 1],
                                     [SPLIT + 1, 2 * SPLIT + 17], [3, SPLIT - 1]])
def test_paged_plain_matches_pallas_over_splits(lengths):
    rng, jcache, tcache, pt = _paged_case(21, lengths)
    q = rng.standard_normal((len(lengths), KVH * G, HD)).astype(np.float32)
    cl = np.asarray(lengths, np.int32)
    want = jax_ops.razer_paged_kv_attention(jnp.asarray(q), jcache, jnp.asarray(pt), jnp.asarray(cl),
                                            force_pallas=True, interpret=True)
    got = ops.razer_paged_kv_attention(torch.from_numpy(q), tcache, torch.from_numpy(pt), torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_verify_plain_matches_pallas_across_a_split_boundary():
    """Committed lengths so that the T = 3 queries straddle a split edge."""
    committed = [SPLIT - 2, 2 * SPLIT - 1]
    rng, jcache, tcache, pt = _paged_case(22, [c + 3 for c in committed])
    q = rng.standard_normal((2, 3, KVH * G, HD)).astype(np.float32)
    cl = np.asarray(committed, np.int32)
    want = jax_ops.razer_paged_kv_attention_verify(jnp.asarray(q), jcache, jnp.asarray(pt), jnp.asarray(cl),
                                                   force_pallas=True, interpret=True)
    got = ops.razer_paged_kv_attention_verify(torch.from_numpy(q), tcache, torch.from_numpy(pt),
                                              torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_contiguous_plain_matches_pallas_over_splits():
    """K3's plain version on a 1024-position cache (the Pallas kernel's
    512-position chunks), lengths over one, two and three splits."""
    rng = np.random.default_rng(23)
    lengths = [SPLIT + 1, 2 * SPLIT + 17, 1000]
    kc, km = jax_kv_quantize(jnp.asarray(rng.standard_normal((3, 1024, KVH, HD)), jnp.float32))
    vc, vm = jax_kv_quantize(jnp.asarray(rng.standard_normal((3, 1024, KVH, HD)), jnp.float32))
    jcache = {"k_codes": kc, "k_meta": km, "v_codes": vc, "v_meta": vm}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    q = rng.standard_normal((3, KVH * G, HD)).astype(np.float32)
    cl = np.asarray(lengths, np.int32)
    want = jax_ops.razer_kv_attention(jnp.asarray(q), jcache, jnp.asarray(cl), force_pallas=True, interpret=True)
    got = ops.razer_kv_attention(torch.from_numpy(q), tcache, torch.from_numpy(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
