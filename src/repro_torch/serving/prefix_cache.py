"""Radix-trie prefix cache: shared-prompt serving without re-prefill —
counterpart of `repro.serving.prefix_cache`.

Requests that open with the same tokens (system prompts, few-shot
templates, multi-turn histories) would otherwise prefill the same prefix
again and again. The cache keeps decode-state snapshots keyed by token
prefixes, so `LMEngine._admit` splices a cached prefix into a fresh slot
and prefills only the suffix.

What a snapshot holds is the family's contract (`ModelApi.prefix_view`):

  attention KV / MLA latents   rows [0, m) on the length axis, the only
                               rows a causal decode reads; a splice
                               writes them into a fresh state whose rows
                               beyond stay zero, as a cold prefill leaves
                               them
  SSM / GRU / xLSTM carries    the fixed-size carry, whole: valid at
                               exactly the snapshot's length m, never
                               cut to a shorter prefix
  step-invariant leaves        (Whisper's encoder memory) whole

Because carries are valid only at their exact length, a lookup never
cuts an entry: `match_longest_prefix` returns the longest whole inserted
entry that prefixes the query, not any trie position. A splice is then
bit for bit the cold state at m, so greedy serving with the cache emits
the tokens serving without it emits.

Eviction is byte-accounted LRU: an entry's snapshot bytes (its tensor
leaves) and 8 bytes a key token count against `capacity_mb`; an insert
past capacity evicts the least recently used entries first (a hit
refreshes recency), and an entry larger than the whole capacity is
rejected. `stats()` gives the counters (hits, misses, evictions, inserts,
bytes), which `LMEngine.cache_stats()` passes on.

The trie and its accounting are plain Python: the snapshots stay where
the engine made them (the card), and nothing here touches them but to
count their bytes.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import LocalCut

__all__ = ["PrefixCache", "snapshot_bytes"]

#: host bookkeeping charged per cached token (trie edges and key tuples)
_TOKEN_OVERHEAD_BYTES = 8


def _as_key(tokens: Iterable) -> tuple:
  """A prompt (list, tuple, numpy array or tensor) as a hashable key."""
  if isinstance(tokens, torch.Tensor):
    tokens = tokens.cpu().numpy()
  arr = np.asarray(tokens)
  if arr.ndim != 1:
    raise ValueError(f"token key must be 1-D, got shape {arr.shape}")
  return tuple(int(t) for t in arr)


def snapshot_bytes(payload: Any) -> int:
  """Accounted size of a snapshot payload: the bytes of every tensor (or
  numpy array) leaf of its nested dicts, lists and tuples. A sharded
  snapshot counts global bytes (a DTensor's global shape, a `LocalCut`'s
  `nbytes`), so a cache under a mesh charges, hits and evicts as one
  without."""
  if isinstance(payload, LocalCut):
    return payload.nbytes
  if isinstance(payload, torch.Tensor):
    return payload.numel() * payload.element_size()
  if isinstance(payload, np.ndarray):
    return int(payload.nbytes)
  if isinstance(payload, dict):
    return sum(snapshot_bytes(v) for v in payload.values())
  if isinstance(payload, (list, tuple)):
    return sum(snapshot_bytes(v) for v in payload)
  return 0


class _Node:
  """One radix-trie node: a compressed edge from its parent, children
  keyed by their edge's first token, and the key of the entry that ends
  exactly here, if one does."""
  __slots__ = ("edge", "children", "key", "parent")

  def __init__(self, edge: tuple = (), parent: Optional["_Node"] = None):
    self.edge = edge
    self.children: dict = {}
    self.key: Optional[tuple] = None
    self.parent = parent


class _Entry:
  __slots__ = ("payload", "nbytes", "node")

  def __init__(self, payload: Any, nbytes: int, node: _Node):
    self.payload = payload
    self.nbytes = nbytes
    self.node = node


class PrefixCache:
  """Byte-accounted LRU cache of decode-state snapshots keyed by token
  prefixes, with radix-trie longest-prefix matching.

  The payload is opaque to the cache (the engine stores a (target
  snapshot, draft snapshot or None) pair); only its tensor leaves are
  counted. `match_longest_prefix` and `common_prefix_len` change nothing;
  `lookup`, the serving entry point, also counts hits and misses and
  refreshes recency."""

  def __init__(self, capacity_mb: float = 256.0, *,
               fork_min_tokens: int = 2):
    if capacity_mb <= 0:
      raise ValueError(f"capacity_mb must be > 0, got {capacity_mb}")
    if fork_min_tokens < 1:
      raise ValueError(
          f"fork_min_tokens must be >= 1, got {fork_min_tokens}")
    self.capacity_bytes = int(capacity_mb * (1 << 20))
    #: the least uncovered shared-prefix depth worth a fork snapshot
    #: (guards against chance one-token overlaps of prompts)
    self.fork_min_tokens = fork_min_tokens
    self._root = _Node()
    #: key -> _Entry, least recently used first (the eviction order)
    self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
    self.bytes = 0
    self.hits = 0
    self.misses = 0
    self.evictions = 0
    self.inserts = 0
    self.rejected_oversize = 0

  def __len__(self) -> int:
    return len(self._entries)

  def __contains__(self, tokens) -> bool:
    return _as_key(tokens) in self._entries

  # -- lookup -----------------------------------------------------------------

  def match_longest_prefix(self, tokens) -> Tuple[int, Any]:
    """The longest inserted entry that is a prefix of `tokens`: (its
    length m, its payload), or (0, None). No inserted entry longer than m
    prefixes `tokens`. Counters and recency are left as they are."""
    key = _as_key(tokens)
    node, depth = self._root, 0
    best: Optional[tuple] = None
    while True:
      if node.key is not None:
        best = node.key
      if depth >= len(key):
        break
      child = node.children.get(key[depth])
      if child is None:
        break
      edge = child.edge
      if len(key) - depth < len(edge) or key[depth:depth + len(edge)] != edge:
        # entries sit only at node boundaries: a partly matched edge
        # holds none
        break
      depth += len(edge)
      node = child
    if best is None:
      return 0, None
    return len(best), self._entries[best].payload

  def common_prefix_len(self, tokens) -> int:
    """The longest common prefix of `tokens` and any inserted key: the
    trie walk's depth, partly matched edges included.

    At least `match_longest_prefix`'s length; a gap between the two is a
    fork two prompts share with no snapshot at it. `LMEngine._admit`
    closes it by stopping its prefill at the fork and publishing the
    state there: carries are valid only at exact lengths, so a fork's
    snapshot must come from a prefill that stops there. Changes
    nothing."""
    key = _as_key(tokens)
    node, depth = self._root, 0
    while depth < len(key):
      child = node.children.get(key[depth])
      if child is None:
        return depth
      edge = child.edge
      limit = min(len(edge), len(key) - depth)
      i = 0
      while i < limit and edge[i] == key[depth + i]:
        i += 1
      depth += i
      if i < len(edge):
        return depth
      node = child
    return depth

  def lookup(self, tokens) -> Tuple[int, Any]:
    """`match_longest_prefix`, counted as a hit or a miss; a hit's entry
    becomes the most recently used."""
    m, payload = self.match_longest_prefix(tokens)
    if m:
      self.hits += 1
      self._entries.move_to_end(_as_key(tokens)[:m])
    else:
      self.misses += 1
    return m, payload

  # -- insert / evict ---------------------------------------------------------

  def insert(self, tokens, payload: Any) -> bool:
    """Admit (tokens -> payload); False when rejected. Inserting a key
    again replaces its payload and refreshes its recency. Least recently
    used entries are evicted until the new one fits; a payload larger
    than the whole capacity is rejected."""
    key = _as_key(tokens)
    if not key:
      raise ValueError("cannot cache an empty prefix")
    nbytes = snapshot_bytes(payload) + _TOKEN_OVERHEAD_BYTES * len(key)
    if nbytes > self.capacity_bytes:
      self.rejected_oversize += 1
      return False
    old = self._entries.get(key)
    if old is not None:
      self.bytes -= old.nbytes
      old.payload, old.nbytes = payload, nbytes
      self.bytes += nbytes
      self._entries.move_to_end(key)
      self._evict_to_fit()
      return True
    while self.bytes + nbytes > self.capacity_bytes:
      self._evict_one()
    node = self._splice_node(key)
    node.key = key
    self._entries[key] = _Entry(payload, nbytes, node)
    self.bytes += nbytes
    self.inserts += 1
    return True

  def _splice_node(self, key: tuple) -> _Node:
    """The node at exactly `key`, made by walking and extending the trie
    and splitting partly matched edges on the way."""
    node, depth = self._root, 0
    while depth < len(key):
      child = node.children.get(key[depth])
      if child is None:
        new = _Node(key[depth:], parent=node)
        node.children[key[depth]] = new
        return new
      edge = child.edge
      common = 0
      limit = min(len(edge), len(key) - depth)
      while common < limit and edge[common] == key[depth + common]:
        common += 1
      if common < len(edge):
        # split: parent -> mid (edge[:common]) -> child (edge[common:])
        mid = _Node(edge[:common], parent=node)
        node.children[key[depth]] = mid
        child.edge = edge[common:]
        child.parent = mid
        mid.children[child.edge[0]] = child
        child = mid
      depth += common
      node = child
    return node

  def _evict_to_fit(self) -> None:
    while self.bytes > self.capacity_bytes:
      self._evict_one()

  def _evict_one(self) -> None:
    _, entry = self._entries.popitem(last=False)
    self.bytes -= entry.nbytes
    self.evictions += 1
    node = entry.node
    node.key = None
    # prune: drop childless nodes without an entry, then merge a
    # pass-through node (no entry, one child) into its child's edge
    while node.parent is not None and node.key is None and not node.children:
      parent = node.parent
      del parent.children[node.edge[0]]
      node = parent
    if (node.parent is not None and node.key is None
        and len(node.children) == 1):
      (only,) = node.children.values()
      only.edge = node.edge + only.edge
      only.parent = node.parent
      node.parent.children[node.edge[0]] = only

  def clear(self) -> None:
    self._root = _Node()
    self._entries.clear()
    self.bytes = 0

  # -- introspection ----------------------------------------------------------

  @classmethod
  def zero_stats(cls) -> dict:
    """`stats()`'s keys with every value zero: an engine without a
    cache reports these."""
    return {k: type(v)() for k, v in cls().stats().items()}

  def stats(self) -> dict:
    """The counters, in the reference's keys."""
    lookups = self.hits + self.misses
    return {
        "hits": self.hits,
        "misses": self.misses,
        "evictions": self.evictions,
        "inserts": self.inserts,
        "rejected_oversize": self.rejected_oversize,
        "entries": len(self._entries),
        "bytes": self.bytes,
        "capacity_bytes": self.capacity_bytes,
        "hit_rate": self.hits / lookups if lookups else 0.0,
    }
