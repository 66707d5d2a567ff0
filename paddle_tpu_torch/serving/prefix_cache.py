"""Automatic prefix caching over the ref-counted paged KV pool.

Counterpart of ``paddle_tpu/serving/prefix_cache.py`` (the port keeps
its own copy: it imports nothing of the JAX package). The
vLLM/PagedAttention (SOSP '23) automatic-prefix-cache design on the
``kv_cache.BlockManager`` primitives: prompt tokens are hashed at BLOCK
granularity into a *chain* key (the digest of a block's tokens folded
over its parent's digest, so a block is only ever matched in the exact
prefix context it was computed in), and every full prompt block a
request finishes prefilling is published under its chain key with one
cache-owned reference (``BlockManager.fork``). A later request whose
prompt starts with the same token chain forks the shared blocks — no
data movement, no recompute — and prefills only the uncovered suffix.

Sharing rules that keep greedy outputs unchanged:

  * only FULL blocks are published and matched — a partially-filled
    block would be written by its owner's next decode step;
  * a match never covers the whole token sequence: at least one token
    is always left to prefill, because the prefill of the final token
    produces the logits the next sample needs. When that cap cuts into
    the last matched block, the engine COPIES it (copy-on-write) so the
    re-written slot never touches the shared original;
  * cached blocks are retained after their last request releases them
    under an LRU entry budget; blocks whose ONLY reference is the
    cache's are *reclaimable* — the engine frees them on demand before
    shedding or preempting, so a warm cache never reads as pool
    pressure.

Eviction is leaf-first along the chains (evicting a middle block would
orphan its descendants' keys while they still hold references), oldest
LRU entry first, and frees the block. All bookkeeping is host-side and
deterministic — no wall-clock, no randomness. With the host spill tier
(``spill=``, ``pool=``) eviction first demotes the block's bytes to host
memory under its chain key, and a lookup that runs off the cached
entries into a demoted chain restores it into a fresh pool block.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict

import torch

__all__ = ["PrefixCache", "PrefixMatch", "prompt_chain_digests"]

# wire form of a chain key: enough hex to make collisions negligible at
# fleet scale while keeping health() snapshots compact
_DIGEST_HEX = 16


def _iter_chain(tokens, block_size):
    """Yield ``(digest, block_index)`` for each FULL block of ``tokens``:
    the digest folds the parent digest in, so equal blocks in different
    prefix contexts never collide. The one hashing implementation behind
    both the cache's keys and the wire digests: they agree byte for byte
    (and with the JAX package's)."""
    h = b""
    for i in range(len(tokens) // block_size):
        payload = " ".join(
            str(int(t)) for t in tokens[i * block_size:(i + 1) * block_size]
        )
        h = hashlib.sha256(h + payload.encode()).digest()
        yield h, i


def prompt_chain_digests(tokens, block_size):
    """Chain digests (hex wire form) of every full block of ``tokens``:
    what a router hashes a request's prompt into to match it against
    the ``prefix_cache_digests`` a replica exports via
    ``Engine.health()``."""
    return [h.hex()[:_DIGEST_HEX] for h, _ in _iter_chain(tokens, block_size)]


class PrefixMatch:
    """One admission-time cache match: ``cache_len`` prompt tokens are
    covered, ``shared_blocks`` are the full blocks to ``fork()``, and
    ``cow_src`` (when the one-token-to-prefill cap cut into the last
    matched block) is the shared block the engine must copy-on-write
    instead of forking."""

    __slots__ = ("cache_len", "shared_blocks", "cow_src", "_digests")

    def __init__(self, cache_len, shared_blocks, cow_src=None, digests=()):
        self.cache_len = int(cache_len)
        self.shared_blocks = list(shared_blocks)
        self.cow_src = cow_src
        self._digests = tuple(digests)  # matched chain, for commit()

    @property
    def num_shared(self):
        return len(self.shared_blocks)

    def __repr__(self):
        return (f"PrefixMatch(cache_len={self.cache_len}, "
                f"shared={self.shared_blocks}, cow_src={self.cow_src})")


class _Entry:
    __slots__ = ("digest", "block", "parent", "children")

    def __init__(self, digest, block, parent):
        self.digest = digest
        self.block = block
        self.parent = parent    # _Entry or None (chain root)
        self.children = 0       # cached entries extending this chain


class PrefixCache:
    """Chain-keyed LRU cache of read-only prompt blocks.

    Holds ONE BlockManager reference per cached block, taken at
    :meth:`register` and released at eviction, so a cached block can
    outlive every request that used it, and ``fork()`` at match time is
    always of a live block. ``capacity_blocks`` bounds the number of
    cached entries (each pins one block); exceeding it evicts leaf
    entries oldest-first."""

    def __init__(self, block_manager, capacity_blocks, metrics=None,
                 spill=None, pool=None):
        if capacity_blocks < 1:
            raise ValueError(
                f"capacity_blocks must be >= 1, got {capacity_blocks}"
            )
        self._bm = block_manager
        self._bs = block_manager.block_size
        self.capacity_blocks = int(capacity_blocks)
        # digest -> _Entry; the OrderedDict's order IS the LRU order
        # (oldest first; commit/register touches move entries to the end)
        self._entries: OrderedDict = OrderedDict()
        self._metrics = metrics
        # host spill tier (serving/spill.py): eviction DEMOTES full chain
        # blocks into it instead of destroying their bytes, and lookup()
        # restores a spilled chain continuation into fresh pool blocks.
        # Needs the physical pool for block reads/writes; without both,
        # eviction behaves exactly as before.
        self._spill = spill if pool is not None else None
        self._pool = pool
        self._sig = (pool.block_signature()
                     if spill is not None and pool is not None else None)
        self._digest_cache = ()   # rebuilt lazily after insert/evict

    def __len__(self):
        return len(self._entries)

    def chain_digests(self):
        """Hex chain keys of every cached entry, in insertion (= chain)
        order: the ``Engine.health()`` export. Cached between membership
        changes."""
        if self._digest_cache is None:
            self._digest_cache = tuple(
                e.digest.hex()[:_DIGEST_HEX] for e in self._entries.values()
            )
        return self._digest_cache

    # -- match ---------------------------------------------------------------
    def lookup(self, tokens, limit):
        """Longest cached prefix of ``tokens``, capped at ``limit`` tokens
        (the engine passes ``len(tokens) - 1`` so at least one token is
        always left to prefill). Returns a :class:`PrefixMatch` or
        ``None``. A pure read: no counter moves and no LRU position
        changes — an admission that stays blocked retries the lookup
        every step, and only the attempt that actually forks the blocks
        counts as a hit (:meth:`commit`). The one side effect is the
        spill tier: a chain walk that runs off the cached entries into a
        SPILLED continuation restores it into fresh pool blocks here
        (idempotent — the restored entry is a plain cached entry, so a
        blocked retry finds it in the cache). A restore may push the
        entry count past ``capacity_blocks`` for a while; the next
        :meth:`register`/:meth:`reclaim` settles it (evicting mid-walk
        would free blocks this match is about to fork)."""
        matched = []
        parent = None
        for digest, i in _iter_chain(tokens, self._bs):
            e = self._entries.get(digest)
            if (e is None and self._spill is not None
                    and i * self._bs < limit):
                e = self._restore(digest, parent)
            if e is None:
                break
            matched.append(e)
            parent = e
        cache_len = min(len(matched) * self._bs, int(limit))
        if cache_len <= 0:
            return None
        n_fork = cache_len // self._bs
        cow_src = matched[n_fork].block if cache_len % self._bs else None
        return PrefixMatch(cache_len, [e.block for e in matched[:n_fork]],
                           cow_src, digests=[e.digest for e in matched])

    def commit(self, match):
        """Book a match the engine actually used (blocks forked or
        copied): counts the hit and touches the matched chain's LRU
        position."""
        for digest in match._digests:
            if digest in self._entries:
                self._entries.move_to_end(digest)
        if self._metrics is not None:
            self._metrics.prefix_hits += 1
            self._metrics.prefix_hit_tokens += match.cache_len

    # -- publish -------------------------------------------------------------
    def register(self, prompt_tokens, block_ids, max_tokens):
        """Publish the full PROMPT blocks of a request whose prefill just
        completed (``max_tokens`` tokens are in the pool). Each newly
        published block gains one cache-owned reference; blocks whose
        chain key is already cached are only LRU-touched: the first
        publisher wins, identical later prompts share ITS blocks."""
        limit = min(len(prompt_tokens), int(max_tokens))
        parent = None
        for digest, i in _iter_chain(prompt_tokens, self._bs):
            if (i + 1) * self._bs > limit or i >= len(block_ids):
                break
            e = self._entries.get(digest)
            if e is not None:
                self._entries.move_to_end(digest)
                parent = e
                continue
            block = block_ids[i]
            self._bm.fork([block])  # the cache's own reference
            e = _Entry(digest, block, parent)
            self._entries[digest] = e
            self._digest_cache = None
            if parent is not None:
                parent.children += 1
            parent = e
        self._enforce_budget()

    # -- spill tier ----------------------------------------------------------
    def _restore(self, digest, parent):
        """Re-materialize a spilled chain block into a fresh pool block:
        one host-to-device write, byte-identical to the block that was
        evicted. Returns the new (cache-owned) entry, or ``None`` on any
        miss — tier miss, no free pool block, an injected ``kv.restore``
        fault, a failed device write — and the chain walk stops there: the
        admission takes the recompute path. A ``torch.AcceleratorError``
        propagates."""
        key = f"prefix:{digest.hex()}"
        if not self._spill.has(key, self._sig):
            return None
        if not self._bm.can_allocate(1):
            # allocation pressure: a restore must never deepen it
            return None
        t0 = time.perf_counter()
        payload = self._spill.get(key, self._sig, pop=True)
        if payload is None:
            return None
        [block] = self._bm.allocate(1)   # the cache's own reference
        try:
            self._pool.write_blocks([block], payload)
        except torch.AcceleratorError:
            self._bm.free([block])
            raise
        except (RuntimeError, ValueError):
            # the degradation contract: a failed device write (out of
            # memory included) frees the block and falls back to
            # recompute
            self._bm.free([block])
            self._spill.note_restore_failure("prefix")
            return None
        finally:
            release = getattr(payload, "release", None)
            if release is not None:
                release()
        e = _Entry(digest, block, parent)
        self._entries[digest] = e
        self._digest_cache = None
        if parent is not None:
            parent.children += 1
        self._spill.note_restored(
            "prefix", payload, time.perf_counter() - t0)
        if self._metrics is not None:
            self._metrics.prefix_restores += 1
        return e

    def _demote(self, e):
        """Best-effort block demotion at eviction: snapshot the block into
        the host tier under its chain key. Any failure (injected
        ``kv.spill`` fault, budget, unreadable block) means the block dies
        as it did before the tier existed."""
        try:
            payload = self._pool.read_blocks([e.block], self._spill.slab)
        except torch.AcceleratorError:
            raise
        except (RuntimeError, ValueError):
            # demotion is an optimization: a failed device read degrades
            # to the old free-and-recompute eviction, counted on the tier
            self._spill.note_spill_failure("prefix")
            return
        self._spill.put(
            f"prefix:{e.digest.hex()}", payload, self._sig,
            num_tokens=self._bs, cls="prefix",
        )

    # -- eviction / reclaim --------------------------------------------------
    def _evict(self, digest):
        e = self._entries.pop(digest)
        self._digest_cache = None
        if e.parent is not None:
            e.parent.children -= 1
        if self._spill is not None:
            # demote instead of destroy: the bytes move to the host tier
            # (keyed by chain digest) BEFORE the device block is freed
            self._demote(e)
        self._bm.free([e.block])
        if self._metrics is not None:
            self._metrics.prefix_evictions += 1

    def _enforce_budget(self):
        while len(self._entries) > self.capacity_blocks:
            victim = next((digest for digest, e in self._entries.items()
                           if e.children == 0), None)   # oldest leaf
            if victim is None:  # unreachable: chains always have leaves
                break
            self._evict(victim)

    def reclaim(self, n, protect=()):
        """Free up to ``n`` blocks back to the pool by evicting LRU leaf
        entries whose block has no owner besides the cache. ``protect``:
        block ids that must survive (a match about to be forked or
        copied). Returns the number freed."""
        n = max(int(n), 0)
        protect = set(protect)
        freed = 0
        progress = True
        # one forward pass evicts every eligible leaf in LRU order; repeat
        # only when an eviction turned a parent into a new leaf (parents
        # sit EARLIER in insertion order, behind the cursor)
        while freed < n and progress:
            progress = False
            for digest, e in list(self._entries.items()):
                if freed >= n:
                    break
                if (e.children or e.block in protect
                        or self._bm.ref_count(e.block) != 1):
                    continue
                self._evict(digest)
                freed += 1
                progress = True
        return freed

    def reclaimable_blocks(self):
        """Cached blocks whose only reference is the cache's: pool slots
        an allocation-pressure path can take back at any time."""
        return sum(1 for e in self._entries.values()
                   if self._bm.ref_count(e.block) == 1)

    def clear(self):
        """Drop every entry (releasing the cache's references)."""
        for digest in list(self._entries):
            self._evict(digest)
