"""Radix-style shared prompt-prefix cache for fused prefill admissions.

Production prompts share structure — a system prompt, a per-tenant task
preamble — and causal attention makes their prefill state reusable: the
KV rows for positions ``[0, L)`` of a prompt depend only on its first
``L`` tokens.  This cache stores the batch-1 post-prefill state of
admitted prompts in a token-level radix trie; a new admission walks the
trie for its longest cached prefix and seeds its prefill from that
state, computing only the suffix (``serve.scheduler.LMTaskBucket.admit``
runs the suffix at ``cache_index = L`` through the same chunked-prefill
write path the engine already uses).

Reusing ``L`` tokens from an entry cached for a *longer* prompt is safe
for attention archs: rows at positions ``>= L`` in the donor state are
stale, but causal masking (prefill attends only positions ``<= q``) and
the decode ``cache_len`` mask guarantee a stale row is always
overwritten before it can be read.  Recurrent archs get no such
truncation property (their state is a running reduction), so the
serving backend simply does not attach a prefix cache to them.

Bookkeeping is host-side and O(prompt length) per lookup; the states
themselves stay wherever the backend put them (state trees of tensors on
the card — the entries ARE the reusable prefill).  The port's prefill
writes its state in place, so the backend clones an entry before
continuing from it (``serve.scheduler.LMTaskBucket``).  A copy of
``repro.serve.slo.prefix``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["RadixPrefixCache"]


@dataclass
class _Node:
    edge: tuple = ()                      # token run from the parent
    children: dict = field(default_factory=dict)   # first token -> _Node
    parent: Optional["_Node"] = None
    key: Optional[tuple] = None           # entry key terminating here


@dataclass
class _Entry:
    state: Any          # batch-1 state tree (tensors on the card)
    length: int         # prompt length the state was prefilled for
    nbytes: int
    node: _Node


def _lcp(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixPrefixCache:
    """LRU-bounded radix trie of (prompt tokens -> prefill state).

    ``lookup`` returns the deepest cached state sharing a prefix with the
    query and the matched length; ``insert`` adds/refreshes an entry and
    evicts least-recently-used prompts beyond ``max_entries``.
    """

    def __init__(self, max_entries: int = 32, min_match: int = 8):
        self.max_entries = int(max_entries)
        self.min_match = int(min_match)
        self.root = _Node()
        self.entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0     # prefill tokens skipped via reuse
        self.insertions = 0
        self.evictions = 0

    # ---------------------------------------------------------- queries

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    def stats(self) -> dict[str, Any]:
        return {"entries": len(self.entries), "bytes": self.nbytes,
                "lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "hit_rate": self.hits / self.lookups if self.lookups
                else 0.0}

    # ----------------------------------------------------------- lookup

    def _subtree_entry(self, node: _Node) -> Optional[_Entry]:
        """Most-recently-used entry at or below ``node`` (every entry in
        the subtree shares the full matched prefix)."""
        best = None
        stack = [node]
        while stack:
            n = stack.pop()
            if n.key is not None:
                e = self.entries.get(n.key)
                if e is not None and (best is None or _mru_rank(
                        self.entries, n.key) > _mru_rank(
                        self.entries, best.node.key)):
                    best = e
            stack.extend(n.children.values())
        return best

    def lookup(self, tokens) -> tuple[Optional[Any], int]:
        """Longest cached prefix of ``tokens``: ``(state, matched)`` or
        ``(None, 0)``.  Counts ``hit_tokens`` only when the caller can
        actually skip work (``matched >= min_match``)."""
        toks = tuple(int(t) for t in tokens)
        self.lookups += 1
        node, matched, i = self.root, 0, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                break
            m = _lcp(child.edge, toks[i:])
            matched += m
            i += m
            if m < len(child.edge):
                node = child        # partial edge: entries below share m
                break
            node = child
        if matched < self.min_match:
            return None, 0
        entry = self._subtree_entry(node)
        if entry is None:
            return None, 0
        matched = min(matched, entry.length)
        self.hits += 1
        self.hit_tokens += matched
        self.entries.move_to_end(entry.node.key)
        return entry.state, matched

    # ----------------------------------------------------------- insert

    def insert(self, tokens, state, nbytes: int) -> None:
        toks = tuple(int(t) for t in tokens)
        if not toks:
            return
        if toks in self.entries:        # refresh: newest state wins
            e = self.entries[toks]
            e.state, e.nbytes = state, int(nbytes)
            self.entries.move_to_end(toks)
            return
        node, i = self.root, 0
        while i < len(toks):
            child = node.children.get(toks[i])
            if child is None:
                leaf = _Node(edge=toks[i:], parent=node)
                node.children[toks[i]] = leaf
                node = leaf
                i = len(toks)
                break
            m = _lcp(child.edge, toks[i:])
            if m < len(child.edge):
                # split the edge: parent -> mid(common run) -> child(rest)
                mid = _Node(edge=child.edge[:m], parent=node)
                child.edge = child.edge[m:]
                child.parent = mid
                mid.children[child.edge[0]] = child
                node.children[toks[i]] = mid
                node = mid
            else:
                node = child
            i += m
        if node.key is None:
            node.key = toks
        self.entries[toks] = _Entry(state=state, length=len(toks),
                                    nbytes=int(nbytes), node=node)
        self.insertions += 1
        while len(self.entries) > self.max_entries:
            self._evict()

    def _evict(self) -> None:
        key, entry = self.entries.popitem(last=False)
        self.evictions += 1
        node = entry.node
        node.key = None
        # prune childless, entry-less nodes back up the path
        while (node.parent is not None and node.key is None
               and not node.children):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent


def _mru_rank(entries: OrderedDict, key) -> int:
    """Position of ``key`` in LRU order (higher = more recent)."""
    for i, k in enumerate(entries):
        if k == key:
            return i
    return -1
