"""Paged KV cache: device block pool + host-side block allocator.

Port of ``scalable_hw_agnostic_inference_tpu/engine/cache.py``
(``BlockAllocator``, ``SeqAllocation``, ``PagedKVCache``; ``:38,90,103``).
The pool is one tensor per layer ``[num_blocks, block_size, n_kv, head_dim]``
on the engine's device; block tables are int32 data, so one launch shape
serves every allocation pattern. Allocation is host-side and O(1) per block.
An int8 pool (``quant=True``, ``SHAI_KV_QUANT=int8``) holds int8 blocks and
one f32 scale per (block, kv head) beside them, ``ks``/``vs`` ``[N, Hkv]``
(``cache.py:151-158``), priced once in :attr:`PagedKVCache.pool_bytes`.

Blocks are refcounted (``cache.py:38-87``): :meth:`PagedKVCache.fork_sequence`
shares a sequence's blocks with a sibling (``SHAI_KV_COW``, the ``n > 1``
fan-out), and :meth:`PagedKVCache.extend` copies a shared partial tail
block before the first divergent write (``cache.py:605-690``). The copy
goes into the pool tensors in place, so a captured decode graph keeps the
pool's addresses. The prefix cache and the host KV tier come in a later
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device


class BlockAllocator:
    """Refcounted free-list allocator over ``total_blocks`` physical blocks.

    Block 0 is reserved as the null block (block tables are padded with 0;
    its contents are garbage but always masked out by sequence lengths).
    A block shared by k sequences (copy-on-write forks) returns to the free
    list only when every holder lets go.
    """

    def __init__(self, total_blocks: int):
        if total_blocks < 2:
            raise ValueError("need at least 2 blocks (0 is reserved)")
        self.total = total_blocks
        self._free: List[int] = list(range(total_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"wanted {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> None:
        if block not in self._ref:
            raise ValueError(f"incref of unallocated block {block}")
        self._ref[block] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; a block returns to the free list
        when its last reference goes."""
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is reserved")
            if b not in self._ref:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
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

    ``kv`` is a list with, per layer, ``{"k": [N, Bs, Hkv, Dh], "v": ...}``,
    plus ``"ks"``/``"vs"`` ``[N, Hkv]`` f32 scales for an int8 pool. The
    runner writes it in place (the reference donates the buffers to its
    jitted steps instead).
    """

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int,
                 total_blocks: int, block_size: int, blocks_per_seq: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, quant: bool = False):
        # the card unless the caller asks for the CPU
        device = resolve_device(device)
        self.n_layers = n_layers
        self.block_size = block_size
        self.blocks_per_seq = blocks_per_seq
        self.total_blocks = total_blocks
        self.quant = quant
        self.allocator = BlockAllocator(total_blocks)
        shape = (total_blocks, block_size, n_kv_heads, head_dim)
        block_dt = torch.int8 if quant else dtype
        self.kv = [{"k": torch.zeros(shape, dtype=block_dt, device=device),
                    "v": torch.zeros(shape, dtype=block_dt, device=device)}
                   for _ in range(n_layers)]
        if quant:
            for lay in self.kv:
                for name in ("ks", "vs"):
                    lay[name] = torch.zeros((total_blocks, n_kv_heads),
                                            dtype=torch.float32,
                                            device=device)
        # a fixed allocation, priced once over every tensor, scales included
        self.pool_bytes = sum(t.nbytes for lay in self.kv
                              for t in lay.values())
        self._seqs: Dict[int, SeqAllocation] = {}
        #: copy-on-write counters (the reference's names): sequences forked
        #: from a parent, and shared tail blocks copied before a write
        self.cow_forks = 0
        self.cow_copies = 0

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

    def fork_sequence(self, parent_id: int, child_id: int) -> SeqAllocation:
        """Admit ``child_id`` sharing every block of ``parent_id`` (one
        incref each): the ``SHAI_KV_COW`` fan-out. Full blocks are never
        written again, so only a shared partial tail can need a private
        copy, which :meth:`extend` makes before the first divergent write;
        release needs nothing special, since a shared block carries a
        refcount above 1 until each holder lets go."""
        if child_id in self._seqs:
            raise ValueError(f"seq {child_id} already admitted")
        parent = self._seqs[parent_id]
        for b in parent.blocks:
            self.allocator.incref(b)
        alloc = SeqAllocation(child_id, list(parent.blocks), parent.n_tokens)
        self._seqs[child_id] = alloc
        self.cow_forks += 1
        return alloc

    def _cow_block(self, alloc: SeqAllocation, idx: int) -> None:
        """Give ``alloc`` a private copy of its shared block
        ``alloc.blocks[idx]``. Allocates before dropping the shared
        reference (a ``MemoryError`` leaves the fork intact for the
        caller's preempt-and-retry ladder), copies every pool leaf (an int8
        pool's blocks and their scale rows byte for byte) in place, on the
        current stream, then swaps the table entry. The last holder never
        copies: its refcount is 1 by then, so n writers pay n - 1 copies."""
        src = alloc.blocks[idx]
        [dst] = self.allocator.alloc(1)
        with torch.inference_mode():
            for lay in self.kv:
                for t in lay.values():
                    t[dst].copy_(t[src])
        self.allocator.free([src])
        alloc.blocks[idx] = dst
        self.cow_copies += 1

    def _cow_pending(self, alloc: SeqAllocation) -> bool:
        """True when growing ``alloc`` writes into a partial tail block
        that another holder still references."""
        idx = alloc.n_tokens // self.block_size
        return (alloc.n_tokens % self.block_size != 0
                and idx < len(alloc.blocks)
                and self.allocator.refcount(alloc.blocks[idx]) > 1)

    def blocks_to_extend(self, seq_id: int, n_new: int = 1) -> int:
        """Fresh blocks :meth:`extend` would need to grow ``seq_id`` by
        ``n_new`` tokens (0 when the current tail block still has room),
        the copy of a shared partial tail included."""
        alloc = self._seqs[seq_id]
        need = max(0, self._blocks_needed(alloc.n_tokens + n_new)
                   - len(alloc.blocks))
        if n_new > 0 and self._cow_pending(alloc):
            need += 1
        return need

    def extend(self, seq_id: int, n_new: int = 1) -> SeqAllocation:
        """Grow a sequence by ``n_new`` tokens, allocating blocks as needed
        and first copying a shared partial tail it is about to write;
        raises ``MemoryError`` when the pool (or the sequence's
        ``blocks_per_seq``) cannot hold them."""
        alloc = self._seqs[seq_id]
        if n_new > 0 and self._cow_pending(alloc):
            self._cow_block(alloc, alloc.n_tokens // self.block_size)
        need = self._blocks_needed(alloc.n_tokens + n_new) - len(alloc.blocks)
        if need > 0:
            if len(alloc.blocks) + need > self.blocks_per_seq:
                raise MemoryError(f"seq {seq_id} exceeds max_model_len")
            alloc.blocks.extend(self.allocator.alloc(need))
        alloc.n_tokens += n_new
        return alloc

    def register_prefix(self, prompt_ids, blocks) -> None:
        """The prefix cache's registration point (the reference's
        ``cache.py:244``): a no-op until the prefix cache is ported, so
        that its callers stand where the reference's do."""

    def release(self, seq_id: int) -> None:
        alloc = self._seqs.pop(seq_id)
        self.allocator.free(alloc.blocks)

    def seq(self, seq_id: int) -> SeqAllocation:
        return self._seqs[seq_id]

    @property
    def leaked_blocks(self) -> int:
        """Allocated blocks no admitted sequence holds — always 0 in a
        correct engine (the exact KV-leak signal); a block shared by
        several sequences counts once on both sides."""
        held = set()
        for a in self._seqs.values():
            held.update(a.blocks)
        used = (self.total_blocks - 1) - self.allocator.n_free  # 0 reserved
        return max(0, used - len(held))

    def _blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))
