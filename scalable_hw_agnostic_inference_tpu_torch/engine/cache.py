"""Paged KV cache: device block pool + host-side block allocator.

Port of ``scalable_hw_agnostic_inference_tpu/engine/cache.py``
(``BlockAllocator``, ``SeqAllocation``, ``PagedKVCache``; ``:38,90,103``).
The pool is one tensor per layer ``[num_blocks, block_size, n_kv, head_dim]``
on the engine's device; block tables are int32 data, so one launch shape
serves every allocation pattern. Allocation is host-side and O(1) per block.
An int8 pool (``quant=True``, ``SHAI_KV_QUANT=int8``) holds int8 blocks and
one f32 scale per (block, kv head) beside them, ``ks``/``vs`` ``[N, Hkv]``
(``cache.py:151-158``), priced once in :attr:`PagedKVCache.pool_bytes`;
``used_bytes`` and ``leaked_bytes`` feed the HBM ledger (``:735-764``).

Blocks are refcounted (``cache.py:38-87``): :meth:`PagedKVCache.fork_sequence`
shares a sequence's blocks with a sibling (``SHAI_KV_COW``, the ``n > 1``
fan-out), and :meth:`PagedKVCache.extend` copies a shared partial tail
block before the first divergent write (``cache.py:605-690``). The copy
goes into the pool tensors in place, so a captured decode graph keeps the
pool's addresses. :meth:`PagedKVCache.shrink` rolls back a speculative
reservation (``cache.py:691``) and counts it (``rollback_tokens``,
``rollback_calls``, ``rollback_blocks``).

Over tensor-parallel ranks each rank's engine builds its own cache with
its ``n_kv_heads / tp`` heads (``EngineShardings.n_kv_heads``; the
reference's ``kv_layer`` split on dim 2, an int8 pool's ``[N, Hkv]``
scales on dim 1): the pool is ``[N, bs, Hkv / tp, D]``, the allocator,
the prefix LRU and the CoW bookkeeping run the same on every rank, and a
CoW copy copies the rank's slice.

The prefix cache (``enable_prefix_caching``, ``cache.py:193-330``): full
blocks are content-addressed by a chain hash over their tokens
(:meth:`PagedKVCache._chain_hashes`, blake2b-64 over little-endian int64
ids, seeded ``0x5351``: the same integers as the reference's, because they
key blocks on the wire between pods); the cache holds one reference per
registered block and evicts LRU, leaves first, when the allocator runs
dry. Registered blocks are never written again (prefill writes only a
sequence's own fresh blocks, decode writes past the prompt), so sharing is
read-only by construction.

The host KV tier (``kvtier/``, ``cache.py:332-575``): with a tier
attached, eviction is a demotion (the evicted blocks are gathered into
fresh tensors on the current stream, before any later allocation can
write them, and their copy to host memory starts), an admission miss
falls through to the tier, and a restore copies the host blocks back into
the pool tensors IN PLACE (never a new pool tensor: the captured graphs
hold the pool's addresses). A prefill-role pod banks each finished
prompt's run in the tier (:meth:`PagedKVCache.demote_prompt_run`), and a
preemption victim's blocks are published to the cache so that pool
pressure demotes them (:meth:`PagedKVCache.offload_preempt`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

#: the closed set of pad sizes the tier movers take: demotion gathers and
#: restore copies pad their index vectors to one of these (padding rows
#: target reserved block 0), as the reference pads to its compiled set
_PAD_SIZES = (1, 2, 4, 8)
_PAD_MAX = _PAD_SIZES[-1]


def _pad_size(n: int) -> int:
    """Smallest registered pad covering ``n`` (callers chunk at _PAD_MAX)."""
    return 1 << max(0, n - 1).bit_length()


class BlockAllocator:
    """Refcounted free-list allocator over ``total_blocks`` physical blocks.

    Block 0 is reserved as the null block (block tables are padded with 0;
    its contents are garbage but always masked out by sequence lengths).
    A block shared by k sequences (copy-on-write forks, prefix sharing) and
    possibly the prefix cache itself returns to the free list only when
    every holder lets go.
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
                 device: DeviceLike = None, quant: bool = False,
                 enable_prefix_caching: bool = False, tier=None):
        # the card unless the caller asks for the CPU
        device = resolve_device(device)
        self.device = device
        self.n_layers = n_layers
        self.block_size = block_size
        self.blocks_per_seq = blocks_per_seq
        self.total_blocks = total_blocks
        self.quant = quant
        self.allocator = BlockAllocator(total_blocks)
        # automatic prefix caching: hash -> block and back, the LRU order
        # (insertion-ordered hash -> None) and the chain links leaf-first
        # eviction walks (evicting a chain HEAD first would strand its
        # cached descendants)
        self.prefix_caching = enable_prefix_caching
        self._hash2block: Dict[int, int] = {}
        self._block2hash: Dict[int, int] = {}
        self._lru: Dict[int, None] = {}
        self._parent: Dict[int, int] = {}
        self._nchild: Dict[int, int] = {}
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
        #: speculative rollback counters (the reference's names): reserved
        #: tokens and blocks given back by :meth:`shrink`, and its calls;
        #: a high rate is the drafter wasting pool headroom
        self.rollback_tokens = 0
        self.rollback_calls = 0
        self.rollback_blocks = 0
        # host KV tier (kvtier/): eviction demotes, misses fall through;
        # its host staging is pinned (False: pageable, to measure that)
        self.tier = None
        self.pin_host = True
        self._tier_gather = None
        self._tier_restore = None
        if tier is not None:
            self.attach_tier(tier)

    # -- prefix cache -------------------------------------------------------

    @staticmethod
    def _chain_hashes(tokens, block_size: int) -> List[int]:
        """Chain hash per FULL block: h_i commits to every token up to and
        including block i, so equal hashes mean equal prefixes. blake2b-64,
        not Python's builtin hash: ``GET /kv/blocks`` keys blocks by these
        values across pods (and across the two packages), so they must be
        a stable function of the tokens alone. 64-bit signed (the frame
        codec's ``<q``)."""
        out = []
        h = 0x5351  # fixed chain seed
        n_full = len(tokens) // block_size
        for i in range(n_full):
            m = hashlib.blake2b(digest_size=8)
            m.update(h.to_bytes(8, "little", signed=True))
            m.update(np.asarray(tokens[i * block_size:(i + 1) * block_size],
                                dtype="<i8").tobytes())
            h = int.from_bytes(m.digest(), "little", signed=True)
            out.append(h)
        return out

    def prefix_hashes(self, tokens) -> List[int]:
        """The prompt's full-block chain hashes, computed once per
        admission attempt and shared by :meth:`cached_prefix`,
        :meth:`tier_prefix_len` and :meth:`restore_prefix`."""
        if not self.prefix_caching:
            return []
        return self._chain_hashes(tokens, self.block_size)

    def cached_prefix(self, tokens, hashes: Optional[List[int]] = None
                      ) -> List[int]:
        """Longest run of cached blocks matching the prompt's full blocks
        (each touched most-recently-used)."""
        if not self.prefix_caching:
            return []
        blocks = []
        for h in (hashes if hashes is not None
                  else self._chain_hashes(tokens, self.block_size)):
            b = self._hash2block.get(h)
            if b is None:
                break
            blocks.append(b)
            self._lru.pop(h, None)
            self._lru[h] = None
        return blocks

    def register_prefix(self, tokens, blocks: List[int]) -> None:
        """Publish a prefilled prompt's full blocks for reuse; the cache
        takes one reference per newly registered block. A hash already
        published, or a physical block already backing another hash, is
        skipped (its chain link still advances)."""
        if not self.prefix_caching:
            return
        prev = None
        for h, b in zip(self._chain_hashes(tokens, self.block_size), blocks):
            if h in self._hash2block or b in self._block2hash:
                prev = h
                continue
            self._hash2block[h] = b
            self._block2hash[b] = h
            self.allocator.incref(b)
            self._lru[h] = None
            if prev is not None and prev in self._hash2block:
                self._parent[h] = prev
                self._nchild[prev] = self._nchild.get(prev, 0) + 1
            prev = h

    @property
    def n_evictable(self) -> int:
        """Cached blocks held ONLY by the cache (refcount 1): reclaimable."""
        return sum(1 for b in self._hash2block.values()
                   if self.allocator.refcount(b) == 1)

    @property
    def n_available(self) -> int:
        """Free blocks plus what eviction could reclaim: the admission
        gate's denominator (with a tier attached, eviction demotes, so an
        evictable block is not lost prefill work)."""
        return self.allocator.n_free + self.n_evictable

    def _evict(self, n: int) -> int:
        """Drop up to ``n`` LRU cache-only blocks, LEAVES first (a chain
        sheds from its tail, or its survivors become unreachable). With a
        tier attached the dropped blocks are demoted: one gather, enqueued
        before the caller's allocation can write them."""
        dropped = 0
        demoted: List[Tuple[int, int]] = []
        progress = True
        while dropped < n and progress:
            progress = False
            for h in list(self._lru):
                if dropped >= n:
                    break
                b = self._hash2block[h]
                if self.allocator.refcount(b) != 1:
                    continue  # still shared by a live sequence
                if self._nchild.get(h, 0):
                    continue  # cached descendants would be stranded
                del self._hash2block[h]
                del self._block2hash[b]
                del self._lru[h]
                parent = self._parent.pop(h, None)
                if parent is not None:
                    self._nchild[parent] -= 1
                    if not self._nchild[parent]:
                        del self._nchild[parent]
                if self.tier is not None and self.tier.accepts(h):
                    demoted.append((h, b))
                self.allocator.free([b])
                dropped += 1
                progress = True
        if demoted:
            # the gather is enqueued on the current stream BEFORE the
            # caller's allocation can write the freed blocks; its outputs
            # are fresh tensors
            self._demote(demoted)
        return dropped

    def _alloc(self, n: int) -> List[int]:
        short = n - self.allocator.n_free
        if short > 0:
            self._evict(short)
        return self.allocator.alloc(n)

    # -- host KV tier (kvtier/) --------------------------------------------

    def attach_tier(self, tier) -> None:
        """Wire a ``kvtier.pool.HostKVTier`` behind the prefix cache, and
        run each mover once (a gather of block 0, and a copy of it back
        into block 0, which is garbage by contract) so that the first
        demotion or restore after readiness loads no kernel."""
        from ..kvtier.restore import make_tier_gather, make_tier_restore

        self.tier = tier
        self._tier_gather = make_tier_gather(quant=self.quant)
        self._tier_restore = make_tier_restore(quant=self.quant)
        idx = torch.zeros((1,), dtype=torch.int64, device=self.device)
        arrays = self._tier_gather(self.kv, idx)
        self._tier_restore(self.kv[0], idx, *(a[0] for a in arrays))

    def _demote(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Copy evicted blocks' KV out to the host tier: one batched gather
        per <=``_PAD_MAX`` chunk, its host copy started and handed to the
        tier (the async worker waits for it, a sync tier here). Failures
        degrade to plain eviction, never raise."""
        from ..kvtier.restore import HostCopy

        tier = self.tier
        try:
            i = 0
            while i < len(pairs):
                grp = list(pairs[i:i + _PAD_MAX])
                n = len(grp)
                idx = np.zeros((_pad_size(n),), np.int64)
                idx[:n] = [b for _, b in grp]
                arrays = self._tier_gather(
                    self.kv, torch.from_numpy(idx).to(self.device))
                tier.store_batch([h for h, _ in grp],
                                 HostCopy(arrays, self.pin_host), n)
                i += n
        except Exception:
            log.warning("kv tier demotion failed; blocks evicted without "
                        "copy", exc_info=True)
            tier.count_error()

    def tier_prefix_len(self, hashes: List[int], from_block: int) -> int:
        """How many full blocks past ``from_block`` the host tier could
        restore for this prompt: the admission ladder's fall-through
        probe when :meth:`cached_prefix` stops short."""
        if self.tier is None or from_block >= len(hashes):
            return 0
        return self.tier.probe_run(hashes[from_block:])

    def restore_prefix(self, hashes: List[int], from_block: int, take: int,
                       pin: Sequence[int] = ()) -> List[int]:
        """Copy up to ``take`` host-tier blocks back into the device pool
        and register them as prefix-cache entries (refcount 1, the cache's
        own reference: the state :meth:`register_prefix` leaves). Returns
        the restored block ids; any shortfall (raced host eviction,
        transfer failure, dry pool) degrades to recompute for the rest.
        ``pin``: the device-cached run the caller is about to share,
        increfed around the allocation so the restore never evicts it."""
        if self.tier is None or take <= 0:
            return []
        run = self.tier.get_run(hashes[from_block:from_block + take])
        if not run:
            return []
        for b in pin:
            self.allocator.incref(b)
        try:
            try:
                blocks = self._alloc(len(run))
            except MemoryError:
                return []
            try:
                self._tier_write(blocks, run)
            except Exception:
                log.warning("kv tier restore failed; falling back to "
                            "recompute", exc_info=True)
                self.allocator.free(blocks)
                self.tier.count_error()
                return []
        finally:
            if pin:
                # pinned blocks are cache-registered (refcount >= 2 while
                # pinned), so this decref never frees them
                self.allocator.free(list(pin))
        prev = hashes[from_block - 1] if from_block > 0 else None
        if prev is not None and prev not in self._hash2block:
            prev = None
        for ent, b in zip(run, blocks):
            h = ent[0]
            self._hash2block[h] = b
            self._block2hash[b] = h
            self._lru[h] = None
            if prev is not None:
                self._parent[h] = prev
                self._nchild[prev] = self._nchild.get(prev, 0) + 1
            prev = h
        self.tier.count_restored(len(blocks))
        return blocks

    def _tier_write(self, blocks: List[int], run: List[Tuple]) -> None:
        """One in-place copy per layer and pool tensor per <=``_PAD_MAX``
        chunk: the restored blocks' host k/v (and an int8 pool's scale
        rows) go back into the pool rows ``blocks`` (padding rows target
        reserved block 0). Pure copies: a restored block is byte-exact."""
        from ..kvtier.restore import staging

        i = 0
        while i < len(blocks):
            grp = blocks[i:i + _PAD_MAX]
            ent = run[i:i + _PAD_MAX]
            n = len(grp)
            pad = _pad_size(n)
            idx = np.zeros((pad,), np.int64)
            idx[:n] = grp
            # entry arrays are [n_layers, <block dims>]; stack per layer:
            # slots 0/1 are the k/v blocks, 2/3 an int8 pool's scales
            host = []
            for ai in range(len(ent[0]) - 1):
                per = ent[0][1 + ai].shape[1:]
                buf = staging((self.n_layers, pad) + per,
                              ent[0][1 + ai].dtype, self.device,
                              self.pin_host)
                rows = buf.numpy()
                rows[:, n:] = 0
                for j, e in enumerate(ent):
                    rows[:, j] = e[1 + ai]
                host.append(buf.to(self.device, non_blocking=True))
            idx_dev = torch.from_numpy(idx).to(self.device)
            for li, lay in enumerate(self.kv):
                self._tier_restore(lay, idx_dev, *(h[li] for h in host))
            i += n

    def demote_prompt_run(self, seq_id: int, prompt_ids) -> int:
        """Prefill-role handoff: copy the sequence's full prompt blocks
        into the host tier WITHOUT evicting them from the device, called at
        request finish before release, so a peer decode pod can pull the
        run over ``GET /kv/blocks`` as soon as the handoff returns. Walks
        the registered blocks (every admission path registers the prompt's
        full blocks), without hashing. A block that is not registered
        duplicates one registered under another physical block (a prompt
        sharing a prefix shorter than the smallest warm start with an
        earlier one, so that it was prefilled afresh): the walk goes on by
        content through that block, hashing the prompt once. (The
        reference ends the walk there, banking only the blocks before it,
        and the peer recomputes the rest.) Returns the full-block count of
        the run banked (at most the handoff's ``hashes_len``)."""
        if self.tier is None or not self.prefix_caching:
            return 0
        alloc = self._seqs.get(seq_id)
        if alloc is None:
            return 0
        n_full = len(prompt_ids) // self.block_size
        pairs: List[Tuple[int, int]] = []
        n_run = 0
        hashes = None
        for i, b in enumerate(alloc.blocks[:n_full]):
            h = self._block2hash.get(b)
            if h is None:
                if hashes is None:
                    hashes = self._chain_hashes(prompt_ids, self.block_size)
                h = hashes[i]
                b = self._hash2block.get(h)
                if b is None:
                    break
            n_run += 1
            if self.tier.accepts(h):
                pairs.append((h, b))
        if pairs:
            self._demote(pairs)
        return n_run

    def demote_token_run(self, seq_id: int,
                         tokens) -> Tuple[int, List[int]]:
        """Bank the sequence's full blocks over ``tokens`` (prompt AND
        generated) in the host tier without evicting them, publishing the
        run first (generated blocks were never content-addressed).
        Returns ``(n_run, hashes[:n_run])``, the leading run banked."""
        if self.tier is None or not self.prefix_caching:
            return 0, []
        alloc = self._seqs.get(seq_id)
        if alloc is None:
            return 0, []
        hashes = self.prefix_hashes(tokens)
        if not hashes:
            return 0, []
        self.register_prefix(tokens, alloc.blocks)
        pairs: List[Tuple[int, int]] = []
        n_run = 0
        for h in hashes:
            # a duplicate prompt's blocks may be registered under ANOTHER
            # physical block: the content-addressed run is intact through
            # that first copy
            src = self._hash2block.get(h)
            if src is None:
                break
            n_run += 1
            if self.tier.accepts(h):
                pairs.append((h, src))
        if pairs:
            self._demote(pairs)
        return n_run, hashes[:n_run]

    def offload_preempt(self, tokens, seq_id: int) -> None:
        """Preemption offload: publish the victim's full blocks to the
        prefix cache (one incref each), so re-admission reuses them while
        they survive and pool pressure demotes them to the tier instead of
        destroying them. Only with a tier attached: the tier-less engine
        keeps its exact preemption accounting."""
        if self.tier is None or not self.prefix_caching:
            return
        alloc = self._seqs.get(seq_id)
        if alloc is None:
            return
        self.register_prefix(tokens, alloc.blocks)

    # -- host-side sequence lifecycle --------------------------------------

    def admit(self, seq_id: int, n_tokens: int,
              reuse_blocks: Optional[List[int]] = None) -> SeqAllocation:
        """Allocate blocks to cover ``n_tokens`` prompt tokens;
        ``reuse_blocks`` are cached prefix blocks to share (increfed
        first, so the allocation of the rest can never evict them)."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already admitted")
        reuse = list(reuse_blocks or [])
        need = self._blocks_needed(n_tokens) - len(reuse)
        assert need >= 0, "reuse longer than the prompt"
        for b in reuse:
            self.allocator.incref(b)
        try:
            fresh = self._alloc(need)
        except MemoryError:
            self.allocator.free(reuse)
            raise
        alloc = SeqAllocation(seq_id, reuse + fresh, n_tokens)
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
        [dst] = self._alloc(1)
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
            alloc.blocks.extend(self._alloc(need))
        alloc.n_tokens += n_new
        return alloc

    def shrink(self, seq_id: int, n_remove: int) -> SeqAllocation:
        """Roll back the last ``n_remove`` reserved tokens, freeing the
        trailing blocks the shorter sequence no longer needs (the
        reference's ``cache.py:691``).

        Speculative decoding reserves ``1 + k`` tokens before verification;
        rejected drafts give their reservation back here, so a partially
        accepted step cannot leak pool blocks. Only fresh decode-tail blocks
        are ever in the rollback range: shared prefix blocks sit at the
        FRONT of an allocation (``admit`` places reused before fresh), and a
        sequence never shrinks below its committed tokens, so a shared
        block's refcount is never touched from here. A tail block copied by
        :meth:`extend`'s copy-on-write is the sequence's own (refcount 1),
        and freeing it returns it like any fresh block."""
        alloc = self._seqs[seq_id]
        if n_remove <= 0:
            return alloc
        if n_remove > alloc.n_tokens:
            raise ValueError(f"shrink of seq {seq_id} by {n_remove} below "
                             f"zero tokens ({alloc.n_tokens} held)")
        alloc.n_tokens -= n_remove
        self.rollback_tokens += n_remove
        self.rollback_calls += 1
        keep = self._blocks_needed(alloc.n_tokens)
        if keep < len(alloc.blocks):
            tail = alloc.blocks[keep:]
            del alloc.blocks[keep:]
            self.allocator.free(tail)
            self.rollback_blocks += len(tail)
        return alloc

    def release(self, seq_id: int) -> None:
        alloc = self._seqs.pop(seq_id)
        self.allocator.free(alloc.blocks)  # cached blocks keep the cache ref

    def seq(self, seq_id: int) -> SeqAllocation:
        return self._seqs[seq_id]

    @property
    def active(self) -> List[int]:
        return sorted(self._seqs)

    @property
    def used_bytes(self) -> float:
        """Logical bytes of the allocated blocks (the reserved null block
        excluded): the pool is one fixed allocation, so block pressure
        shows here, not in :attr:`pool_bytes`."""
        used = (self.total_blocks - 1) - self.allocator.n_free
        return self.pool_bytes * (used / self.total_blocks)

    @property
    def leaked_bytes(self) -> float:
        """Bytes of :attr:`leaked_blocks`: the HBM ledger's drift feed."""
        return self.pool_bytes * (self.leaked_blocks / self.total_blocks)

    @property
    def leaked_blocks(self) -> int:
        """Allocated blocks neither an admitted sequence nor the prefix
        cache holds — always 0 in a correct engine (the exact KV-leak
        signal); a block shared by several holders counts once on both
        sides."""
        held = set()
        for a in self._seqs.values():
            held.update(a.blocks)
        held.update(self._block2hash)
        used = (self.total_blocks - 1) - self.allocator.n_free  # 0 reserved
        return max(0, used - len(held))

    def _blocks_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))
