"""Paged KV cache: device block pool + host-side block allocator.

Port of ``scalable_hw_agnostic_inference_tpu/engine/cache.py``
(``BlockAllocator``, ``SeqAllocation``, ``PagedKVCache``; ``:38,90,103``).
The pool is one tensor per layer ``[num_blocks, block_size, n_kv, head_dim]``
on the engine's device; block tables are int32 data, so one launch shape
serves every allocation pattern. Allocation is host-side and O(1) per block.

The prefix cache, the host KV tier and copy-on-write forks (and with them
shared, refcounted blocks) come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

import numpy as np
import torch


class BlockAllocator:
    """Free-list allocator over ``total_blocks`` physical blocks.

    Block 0 is reserved as the null block (block tables are padded with 0;
    its contents are garbage but always masked out by sequence lengths).
    """

    def __init__(self, total_blocks: int):
        if total_blocks < 2:
            raise ValueError("need at least 2 blocks (0 is reserved)")
        self.total = total_blocks
        self._free: List[int] = list(range(total_blocks - 1, 0, -1))
        self._used: Set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"wanted {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the free list."""
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is reserved")
            if b not in self._used:
                raise ValueError(f"double free of block {b}")
            self._used.remove(b)
            self._free.append(b)


@dataclasses.dataclass
class SeqAllocation:
    """Host bookkeeping for one running sequence."""

    seq_id: int
    blocks: List[int]
    n_tokens: int = 0

    def table(self, blocks_per_seq: int) -> np.ndarray:
        t = np.zeros((blocks_per_seq,), np.int32)
        t[: len(self.blocks)] = self.blocks
        return t


class PagedKVCache:
    """Device block pool + per-sequence block accounting.

    ``kv`` is a list with, per layer, ``{"k": [N, Bs, Hkv, Dh], "v": ...}``.
    The runner writes it in place (the reference donates the buffers to its
    jitted steps instead).
    """

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 total_blocks: int, block_size: int, blocks_per_seq: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device = torch.device("cpu")):
        self.n_layers = n_layers
        self.block_size = block_size
        self.blocks_per_seq = blocks_per_seq
        self.total_blocks = total_blocks
        self.allocator = BlockAllocator(total_blocks)
        shape = (total_blocks, block_size, n_kv_heads, head_dim)
        self.kv = [{"k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device)}
                   for _ in range(n_layers)]
        self._seqs: Dict[int, SeqAllocation] = {}

    @property
    def n_available(self) -> int:
        """Blocks the admission gate may promise (free blocks; with the
        prefix cache, later, plus what eviction could reclaim)."""
        return self.allocator.n_free

    def admit(self, seq_id: int, n_tokens: int) -> SeqAllocation:
        """Allocate blocks to cover ``n_tokens`` prompt tokens."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already admitted")
        alloc = SeqAllocation(seq_id,
                              self.allocator.alloc(
                                  self._blocks_needed(n_tokens)),
                              n_tokens)
        self._seqs[seq_id] = alloc
        return alloc

    def blocks_to_extend(self, seq_id: int, n_new: int = 1) -> int:
        """Fresh blocks :meth:`extend` would need to grow ``seq_id`` by
        ``n_new`` tokens (0 when the current tail block still has room)."""
        alloc = self._seqs[seq_id]
        return max(0, self._blocks_needed(alloc.n_tokens + n_new)
                   - len(alloc.blocks))

    def extend(self, seq_id: int, n_new: int = 1) -> SeqAllocation:
        """Grow a sequence by ``n_new`` tokens, allocating blocks as needed;
        raises ``MemoryError`` when the pool (or the sequence's
        ``blocks_per_seq``) cannot hold them."""
        alloc = self._seqs[seq_id]
        need = self.blocks_to_extend(seq_id, n_new)
        if need > 0:
            if len(alloc.blocks) + need > self.blocks_per_seq:
                raise MemoryError(f"seq {seq_id} exceeds max_model_len")
            alloc.blocks.extend(self.allocator.alloc(need))
        alloc.n_tokens += n_new
        return alloc

    def release(self, seq_id: int) -> None:
        alloc = self._seqs.pop(seq_id)
        self.allocator.free(alloc.blocks)

    def seq(self, seq_id: int) -> SeqAllocation:
        return self._seqs[seq_id]

    @property
    def leaked_blocks(self) -> int:
        """Allocated blocks no admitted sequence holds — always 0 in a
        correct engine (the exact KV-leak signal)."""
        held = set()
        for a in self._seqs.values():
            held.update(a.blocks)
        used = (self.total_blocks - 1) - self.allocator.n_free  # 0 reserved
        return max(0, used - len(held))

    def _blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))
