"""Paged KV-cache block allocator: free-list, ref-counts, prefix sharing.

The paper's end-to-end claim (DESIGN.md §1, §10) is that compressed weights
*free HBM that converts into a larger effective batch*. The dense per-slot
cache (`[n_slots, max_len]`, DESIGN.md §7) cannot cash that in: a 2048-token
slot holding a 40-token request wastes >98% of its KV memory, and `n_slots`
is a hand-picked constant. This module is the host-side half of the paged
replacement:

* **BlockPool** — a fixed pool of ``n_blocks`` KV blocks of ``block_size``
  token positions each, backed on device by one ``[n_blocks, block, ...]``
  array per cache leaf (`transformer.init_paged_cache`). Physical block 0
  is reserved as the *trash block*: padded table entries and bucket-padding
  writes land there, so scatters never need a validity branch; its content
  is junk and every read of it is masked.
* **BlockTable** — per-request list of physical block ids; logical block
  ``j`` holds token positions ``[j*block, (j+1)*block)`` (ring residues for
  sliding-window configs).
* **Prefix sharing** — full prompt blocks are keyed by an exact *chain
  key* ``(parent_physical_block, token_chunk)``: causal attention makes a
  block's K/V a pure function of the token prefix up to its end, and the
  parent block id pins that prefix inductively, so key-equal blocks are
  bit-identical and one physical block can back any number of requests
  (ref-counted). Keys compare full token tuples — a hash collision can
  never alias two different prefixes onto one block. Blocks whose
  ref-count drops to 0 stay key-registered on the free list (an evictable
  cache, LRU-reused), so a popular prefix survives request churn.
* **Copy-on-write** — a write may only target a block with ref-count 1.
  ``ensure_writable`` copies a shared block into a fresh one (the device
  copy is the caller's job — `transformer.copy_cache_block`) and swaps the
  table entry. On the serving path sharing covers only *full prompt*
  blocks, which decode never writes into, so CoW triggers via ``fork``
  (parallel sampling: two generation branches over one prompt table).

The scheduler half (admission by block availability, preempt-and-requeue on
exhaustion, the budget that sizes ``n_blocks`` from the Tiled-CSL weight
savings) lives in `serving/batching.py` and `serving/budget.py`.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

TRASH_BLOCK = 0   # reserved physical block: padding writes / padded table
                  # entries point here; never allocated, never read unmasked


class PoolExhausted(RuntimeError):
    """No free block available (admission defers / decode preempts)."""


def chain_key(parent: Optional[int], chunk: Sequence[int]
              ) -> Tuple[Optional[int], Tuple[int, ...]]:
    """Exact content key of one full token block: (parent physical block,
    token chunk).

    The parent link makes the key a function of the *entire* prefix, not
    just the chunk — required because K/V at position t depends (through
    attention) on every token <= t, so only whole-prefix-equal blocks are
    shareable. Keying by the parent's physical id (unique while the parent
    is registered) instead of a rolling hash means lookups compare real
    token tuples: two different prefixes can never alias one block.
    """
    return (parent, tuple(int(t) for t in chunk))


@dataclasses.dataclass
class BlockTable:
    """Physical block ids backing one request's cache positions."""

    blocks: List[int] = dataclasses.field(default_factory=list)
    n_shared: int = 0            # leading entries obtained via a prefix hit

    def padded(self, n: int) -> np.ndarray:
        """[n] int32 device-table row, trailing entries = trash block."""
        row = np.full(n, TRASH_BLOCK, np.int32)
        row[: len(self.blocks)] = self.blocks
        return row


class BlockPool:
    """Fixed pool of KV blocks: free-list + ref-counts + prefix-hash cache.

    ``n_blocks`` counts *usable* blocks; physically the device arrays carry
    ``n_blocks + 1`` rows (row 0 is the trash block). ``block`` is the
    token positions per block.
    """

    def __init__(self, n_blocks: int, block: int, *,
                 prefix_sharing: bool = True):
        if n_blocks < 1:
            raise ValueError(f"need at least 1 usable block, got {n_blocks}")
        if block < 1:
            raise ValueError(f"block size must be >= 1, got {block}")
        self.n_blocks = n_blocks
        self.block = block
        self.prefix_sharing = prefix_sharing
        self.physical_blocks = n_blocks + 1          # + trash block 0
        self.ref = np.zeros(self.physical_blocks, np.int64)
        self.ref[TRASH_BLOCK] = 1                    # permanently reserved
        # LRU free list: ref==0 blocks, oldest-freed first. Freed blocks
        # KEEP their key registration until reallocated (evictable cache).
        self._free: "OrderedDict[int, None]" = OrderedDict(
            (b, None) for b in range(1, self.physical_blocks))
        self._key_of: Dict[int, Any] = {}            # block -> chain key
        self._block_of: Dict[Any, int] = {}          # chain key -> block
        # parent block -> registered child blocks: a chain key embeds its
        # parent's physical id, so reallocating a parent must invalidate
        # every key that chains through it (the id no longer names that
        # prefix). One level suffices: deeper descendants become
        # unreachable (no registered path resolves to their parent) and
        # are invalidated when their own parent is eventually reallocated.
        self._children: Dict[int, Set[int]] = {}

    # -- introspection ------------------------------------------------------
    @property
    def available(self) -> int:
        """Blocks allocatable right now (incl. evictable cached blocks)."""
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - self.available

    def check_invariants(self) -> None:
        """Ref-count bookkeeping must tie out exactly (leak tripwire)."""
        live = int((self.ref[1:] > 0).sum())
        assert live == self.blocks_in_use, (live, self.blocks_in_use)
        assert all(self.ref[b] == 0 for b in self._free)
        for key, b in self._block_of.items():
            assert self._key_of.get(b) == key, (key, b)
        for parent, kids in self._children.items():
            for c in kids:
                k = self._key_of.get(c)
                assert k is not None and k[0] == parent, (parent, c, k)

    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to hold ``n_positions`` cache positions."""
        return -(-n_positions // self.block)

    # -- core alloc/free ----------------------------------------------------
    def _drop_key(self, b: int) -> None:
        key = self._key_of.pop(b, None)
        if key is None:
            return
        del self._block_of[key]
        parent = key[0]
        if parent is not None:
            kids = self._children.get(parent)
            if kids is not None:
                kids.discard(b)
                if not kids:
                    del self._children[parent]

    def _unregister(self, b: int) -> None:
        """Called when ``b``'s content is about to change (reallocation):
        drop its own key and every key chaining through its id."""
        self._drop_key(b)
        for child in tuple(self._children.get(b, ())):
            self._drop_key(child)
        self._children.pop(b, None)

    def _register(self, b: int, key) -> None:
        self._key_of[b] = key
        self._block_of[key] = b
        if key[0] is not None:
            self._children.setdefault(key[0], set()).add(b)

    def alloc(self) -> int:
        """Take one block (LRU evicting a cached free block if needed)."""
        if not self._free:
            raise PoolExhausted(
                f"all {self.n_blocks} KV blocks in use")
        b, _ = self._free.popitem(last=False)
        self._unregister(b)                          # its cached prefix dies
        self.ref[b] = 1
        return b

    def incref(self, b: int) -> None:
        assert b != TRASH_BLOCK
        if self.ref[b] == 0:                         # revive cached block
            del self._free[b]
        self.ref[b] += 1

    def decref(self, b: int) -> None:
        assert b != TRASH_BLOCK and self.ref[b] > 0
        self.ref[b] -= 1
        if self.ref[b] == 0:
            # Back on the free list but still hash-registered: a future
            # prefix hit revives it with its contents intact.
            self._free[b] = None

    def free_table(self, table: BlockTable) -> None:
        for b in table.blocks:
            self.decref(b)
        table.blocks = []
        table.n_shared = 0

    # -- prefix sharing -----------------------------------------------------
    def map_prompt(self, tokens: np.ndarray, n_positions: int
                   ) -> Tuple[BlockTable, int]:
        """Build a block table covering positions ``[0, n_positions)`` for a
        prompt, sharing chain-hash-equal full prompt blocks.

        Returns (table, prefix_hit_tokens). Rolls every allocation back and
        raises :class:`PoolExhausted` if the pool cannot cover the request,
        so a failed admission leaves the pool untouched.
        """
        need = self.blocks_for(n_positions)
        n_full = min(len(tokens) // self.block, need)
        table = BlockTable()
        hit_tokens = 0
        parent: Optional[int] = None
        try:
            sharing = self.prefix_sharing
            for j in range(need):
                if sharing and j < n_full:
                    key = chain_key(parent, tokens[j * self.block:
                                                   (j + 1) * self.block])
                    b = self._block_of.get(key)
                    if b is not None:
                        self.incref(b)
                        table.blocks.append(b)
                        table.n_shared += 1
                        hit_tokens += self.block
                        parent = b
                        continue
                    b = self.alloc()
                    self._register(b, key)
                    table.blocks.append(b)
                    parent = b
                    continue
                # partial tail / reservation blocks: private, unkeyed
                table.blocks.append(self.alloc())
        except PoolExhausted:
            self.free_table(table)
            raise
        return table, hit_tokens

    # -- decode-time growth / copy-on-write --------------------------------
    def ensure_capacity(self, table: BlockTable, logical: int) -> bool:
        """Grow ``table`` so logical block ``logical`` exists.

        Returns True if a block was allocated. Raises PoolExhausted when the
        pool is empty (caller preempts and retries).
        """
        if logical < len(table.blocks):
            return False
        if logical != len(table.blocks):
            raise ValueError(
                f"non-contiguous growth: table has {len(table.blocks)} "
                f"blocks, asked for logical block {logical}")
        table.blocks.append(self.alloc())
        return True

    def ensure_writable(self, table: BlockTable, logical: int
                        ) -> Optional[Tuple[int, int]]:
        """Copy-on-write: make logical block ``logical`` private.

        Returns (src, dst) physical ids when a copy is needed — the caller
        must copy the device contents src -> dst — or None if the block is
        already private. The fresh block is unhashed: the fork's writes
        diverge from the shared prefix by definition.
        """
        b = table.blocks[logical]
        if self.ref[b] <= 1:
            return None
        dst = self.alloc()
        self.decref(b)
        table.blocks[logical] = dst
        table.n_shared = min(table.n_shared, logical)
        return b, dst

    def fork(self, table: BlockTable) -> BlockTable:
        """Second generation branch over the same cache (parallel sampling):
        every block is shared until a write triggers copy-on-write."""
        for b in table.blocks:
            self.incref(b)
        return BlockTable(blocks=list(table.blocks),
                          n_shared=len(table.blocks))
