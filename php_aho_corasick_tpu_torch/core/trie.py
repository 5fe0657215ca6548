"""Pure-Python trie builder (the port's only builder; the JAX package's C++
builder is not carried over).

Capability parity with the reference's insertion layer
(``src/multifast/ahocorasick.c:91-131`` ``ac_trie_add`` and
``src/multifast/node.c`` node management), re-designed for table compilation:
nodes are integer ids with dict edges, and finalize-time work (BFS failure
links, match-set union, dense goto∘fail closure) lives in
:mod:`php_aho_corasick_tpu_torch.core.automaton`.

Validation statuses mirror ``AC_STATUS_t`` (``actypes.h:118-125``): empty
pattern, overlong pattern (> max_pattern_length, reference limit 1024 at
``actypes.h:148``), duplicate pattern, and closed (finalized) trie.
"""

from __future__ import annotations

from typing import Dict, List

from ..errors import AddStatus


class TrieBuilder:
    """Incremental byte-trie.

    State ids are dense ints; 0 is the root.  ``own[s]`` is the index of the
    pattern whose full text ends exactly at ``s`` (or -1) — the analog of the
    reference's per-node matched list *before* failure-chain union
    (``node_accept_pattern``, ``src/multifast/node.c:205-229``; a node can
    own at most one pattern because duplicates are rejected).
    """

    def __init__(self, max_pattern_length: int = 1024) -> None:
        self.max_pattern_length = int(max_pattern_length)
        self.children: List[Dict[int, int]] = [{}]
        self.depth: List[int] = [0]
        self.own: List[int] = [-1]
        self.closed = False
        self.n_patterns = 0
        self.max_len = 0  # longest accepted pattern, drives halo width

    @property
    def n_states(self) -> int:
        return len(self.children)

    def add(self, pattern: bytes) -> AddStatus:
        """Insert one pattern; returns the per-pattern status.

        On any non-SUCCESS status the trie is unchanged w.r.t. accepted
        patterns (nodes created while walking a rejected duplicate are the
        shared prefix path and carry no accept marks) — matching the
        reference's observable behavior where rejected patterns simply never
        match (``ahocorasick.c:91-131``).
        """
        if self.closed:
            return AddStatus.TRIE_CLOSED
        n = len(pattern)
        if n == 0:
            return AddStatus.ZERO_PATTERN
        if n > self.max_pattern_length:
            return AddStatus.LONG_PATTERN

        s = 0
        for b in pattern:
            nxt = self.children[s].get(b)
            if nxt is None:
                nxt = len(self.children)
                self.children[s][b] = nxt
                self.children.append({})
                self.depth.append(self.depth[s] + 1)
                self.own.append(-1)
            s = nxt
        if self.own[s] != -1:
            return AddStatus.DUPLICATE_PATTERN
        self.own[s] = self.n_patterns
        self.n_patterns += 1
        self.max_len = max(self.max_len, n)
        return AddStatus.SUCCESS
