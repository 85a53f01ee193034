"""Draft sources for speculative decoding: counterpart of
`mllm_tpu/generation/draft.py`, copied (it is numpy only; the port imports
nothing of the JAX package).

`SuffixAutomaton` proposes continuations from repeated substrings of the
already-generated stream (the reference's Draft.hpp); `TracePool` manages
candidate traces and computes the tree-attention metadata for multi-trace
verification. Host-side Python, as in the reference: drafting is control
logic, not tensor math.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class SuffixAutomaton:
    """Online suffix automaton over the generated token stream.

    After each `add_token`, (match_state, match_len) track the longest suffix
    of the stream that also occurs earlier; `lookup` drafts the continuation
    found at that earlier occurrence (the reference's Draft.hpp).
    """

    def __init__(self):
        self.next: list[dict[int, int]] = [{}]
        self.link: list[int] = [-1]
        self.length: list[int] = [0]
        self.first_pos: list[int] = [-1]
        self.last = 0
        self.tokens: list[int] = []
        # online matching state
        self.match_state = 0
        self.match_len = 0

    def _clone(self, q: int) -> int:
        self.next.append(dict(self.next[q]))
        self.link.append(self.link[q])
        self.length.append(0)
        self.first_pos.append(self.first_pos[q])
        return len(self.next) - 1

    def _new_state(self) -> int:
        self.next.append({})
        self.link.append(-1)
        self.length.append(0)
        self.first_pos.append(-1)
        return len(self.next) - 1

    def add_token(self, c: int):
        # --- online match update (before extending, against existing SA) ---
        s, l = self.match_state, self.match_len
        while s != 0 and c not in self.next[s]:
            s = self.link[s]
            l = self.length[s]
        if c in self.next[s]:
            s = self.next[s][c]
            l += 1
        else:
            s, l = 0, 0
        self.match_state, self.match_len = s, l

        # --- standard SA extend ---
        pos = len(self.tokens)
        self.tokens.append(c)
        cur = self._new_state()
        self.length[cur] = self.length[self.last] + 1
        self.first_pos[cur] = pos
        p = self.last
        while p != -1 and c not in self.next[p]:
            self.next[p][c] = cur
            p = self.link[p]
        if p == -1:
            self.link[cur] = 0
        else:
            q = self.next[p][c]
            if self.length[p] + 1 == self.length[q]:
                self.link[cur] = q
            else:
                clone = self._clone(q)
                self.length[clone] = self.length[p] + 1
                while p != -1 and self.next[p].get(c) == q:
                    self.next[p][c] = clone
                    p = self.link[p]
                self.link[q] = clone
                self.link[cur] = clone
        self.last = cur

    def add_tokens(self, toks):
        for t in toks:
            self.add_token(int(t))

    def lookup_multi(self, max_draft: int = 8, min_match: int = 1,
                     max_traces: int = 4) -> list[list[int]]:
        """Candidate continuations from the current match state and its
        suffix-link ancestors (shorter matches → alternative continuations),
        deduped by first token (reference TracePool candidate gathering)."""
        out: list[list[int]] = []
        seen_first: set[int] = set()
        s, l = self.match_state, self.match_len
        while s != 0 and len(out) < max_traces:
            if l >= min_match:
                end = self.first_pos[s]
                cont = self.tokens[end + 1 : end + 1 + max_draft]
                if cont and cont[0] not in seen_first:
                    out.append([int(t) for t in cont])
                    seen_first.add(cont[0])
            s = self.link[s]
            l = self.length[s] if s >= 0 else 0
        return out

    def lookup(self, max_draft: int = 40, min_match: int = 1) -> list[int]:
        """Draft the continuation after the earlier occurrence of the current
        longest matched suffix.  Empty when no sufficiently long repeat."""
        if self.match_len < min_match or self.match_state == 0:
            return []
        end = self.first_pos[self.match_state]  # end index of earlier occurrence
        start = end + 1
        if start >= len(self.tokens) - 1:  # continuation would just be the tail itself
            pass
        cont = self.tokens[start : start + max_draft]
        # don't propose the suffix we're currently inside (overlap is fine—the
        # earlier occurrence's continuation may extend past the current tail)
        return [int(t) for t in cont]


@dataclass
class Trace:
    tokens: list[int]


class TracePool:
    """Multiple candidate traces verified in one forward via tree attention
    (reference Draft.hpp:23-128).

    `build_tree` flattens the traces into (input_ids, position_ids,
    tree_ancestors) where ancestors index into the flattened draft; the tree
    attention bias lets token i attend only to its ancestor chain.
    """

    def __init__(self, max_traces: int = 4):
        self.traces: list[Trace] = []
        self.max_traces = max_traces

    def clear(self):
        self.traces = []

    def add_trace(self, tokens):
        if len(self.traces) < self.max_traces and tokens:
            self.traces.append(Trace([int(t) for t in tokens]))

    def build_tree(self, base_pos: int):
        """Returns (ids [N], positions [N], ancestors [N] int32 with -1=root).

        Trace t's token j has ancestor = previous token of the same trace.
        """
        ids, pos, anc = [], [], []
        for tr in self.traces:
            prev = -1
            for j, t in enumerate(tr.tokens):
                ids.append(t)
                pos.append(base_pos + j)
                anc.append(prev)
                prev = len(ids) - 1
        return (np.asarray(ids, np.int32), np.asarray(pos, np.int32),
                np.asarray(anc, np.int32))

    @staticmethod
    def tree_bias(ancestors: np.ndarray) -> np.ndarray:
        """Additive attention bias [N, N]: token i may attend to j iff j is on
        i's ancestor chain (or i==j).  (Reference CausalTreeMask.)"""
        n = len(ancestors)
        ok = np.zeros((n, n), bool)
        for i in range(n):
            ok[i, i] = True
            a = ancestors[i]
            while a != -1:
                ok[i, a] = True
                a = ancestors[a]
        return np.where(ok, 0.0, -1e30).astype(np.float32)

    def eval_posterior(self, out_tokens: np.ndarray) -> tuple[int, int]:
        """Pick the trace with the longest accepted prefix.

        out_tokens: [N] argmax prediction at each flattened draft position
        (prediction of the NEXT token).  Returns (trace_idx, n_accepted):
        trace tokens [0..n_accepted) were confirmed; out at the last accepted
        position is the bonus token.  (Reference evalPosterior, Draft.hpp:65-104.)
        """
        best, best_n = 0, 0
        off = 0
        for ti, tr in enumerate(self.traces):
            n = len(tr.tokens)
            acc = 0
            for j in range(n - 1):
                if out_tokens[off + j] == tr.tokens[j + 1]:
                    acc += 1
                else:
                    break
            if acc > best_n:
                best, best_n = ti, acc
            off += n
        return best, best_n
