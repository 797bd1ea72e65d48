"""The split plan of the decode-attention kernels K3, K4 and K5
(``csrc/razer_kv_attend.cuh``), and their workspace.

A sequence of length L is attended in splits of ``SPLIT`` positions,
[0, 256), [256, 512), ...: the cut is a function of L alone, and the
kernels combine the splits' partials in split order, so a sequence's output
does not depend on the batch, the grid or the card.  The grid is sized from
the span the host knows without a sync (the page table's NP * ps, or the
cache's S); each block writes its split's partial to a float32 workspace;
the last of each group of ``GROUP`` splits to finish (an int32 ticket per
(b, kv head, group)) combines the group, and, where a sequence has more than
one group, the last group (a ticket per (b, kv head)) combines the groups.
The constants here are copies of the CUDA ones (``tests/test_torch_attention_plan.py``
holds them equal).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["SPLIT", "CHUNK", "GROUP", "MAX_G", "MAX_ROWS", "HEAD_DIMS", "num_splits", "num_groups", "partial_floats",
           "workspace_size", "workspace"]

SPLIT = 256  # positions per split: a multiple of CHUNK and of the page size 16
CHUNK = 64  # positions a block stages and computes per step
MAX_G = 8  # query rows per kv head
MAX_ROWS = 32  # T * G query rows of one block (K5 launches once per MAX_ROWS // G queries)
GROUP = 8  # splits combined together first
HEAD_DIMS = (16, 64, 128)  # the head widths the kernels are built for: the configs' 128 (16 reduced), the tests' 64


def num_splits(length: int) -> int:
    """Splits of a sequence of ``length`` positions (one for an empty one)."""
    return max(1, -(-int(length) // SPLIT))


def num_groups(splits: int) -> int:
    """Groups of ``GROUP`` consecutive splits (the first level of the combine)."""
    return -(-int(splits) // GROUP)


def partial_floats(rows: int, hd: int) -> int:
    """Floats of one split's partial: the (rows, hd) weighted V sum, then
    each row's max and sum, padded to a multiple of 4."""
    return rows * hd + ((2 * rows + 3) & ~3)


def workspace_size(b: int, kvh: int, span: int, rows: int, hd: int) -> Tuple[int, int]:
    """(float32 workspace floats, int32 tickets) of a call over ``span``
    positions (NP * ps or S): a partial per split and per group, a ticket
    per group and one per (b, kv head)."""
    ns = num_splits(span)
    ng = num_groups(ns)
    return b * kvh * (ns + ng) * partial_floats(rows, hd), b * kvh * (ng + 1)


_CACHE: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device: torch.device, floats: int, tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 workspace of at least ``floats`` and ``tickets`` int32
    counters on ``device``, kept between calls and grown when a call needs
    more.  The counters start at zero and every call leaves them zero; calls
    that share them run in order on one stream."""
    key = (device.type, device.index if device.index is not None else torch.cuda.current_device())
    ws, counters = _CACHE.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tickets:
        counters = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _CACHE[key] = (ws, counters)
    return ws, counters
