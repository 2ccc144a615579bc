"""Prefix trees (tries) of signals with per-protein counts.

Behavioral parity: MCsimlib.py:1224-1785, 2223-2310 —
including the reference's odd addressing convention, where a subsignal
passed to a NON-root node names the node itself in element 0 and the
child in element 1 (so ``get_descendant`` on a non-root node with a
1-element subsignal returns the node without checking the block).

The implementation here is its own: every operation normalizes the
reference's subsignal convention into a child-key path once
(``_rel_path``) and then runs iterative walks (``_follow``) or a single
unified depth-first generator (``_iter_nodes``) — there is no per-method
recursion mirroring the original. Only the observable behavior (method
results, iteration order, assert conditions, mutation effects) matches.
"""

from __future__ import annotations


class _CountTrieBase:
    """Shared machinery for block-keyed tries with per-protein counts."""

    NULL_BLOCK: tuple = ()

    def __init__(self, signal_block):
        self.signal_block = tuple(signal_block)
        self.descendants = {}
        self.signal_count = {}

    def _is_root(self):
        return self.signal_block == self.NULL_BLOCK

    # -- addressing ----------------------------------------------------

    def _rel_path(self, subsignal):
        """Reference subsignal convention -> child-key path from self.

        At the root the whole subsignal is the path; at any other node,
        element 0 names the node itself and the path starts at element 1.
        """
        blocks = list(subsignal)
        return blocks if self._is_root() else blocks[1:]

    def _follow(self, path, create=False):
        """Walk a child-key path; optionally create missing nodes."""
        node = self
        for key in path:
            child = node.descendants.get(key)
            if child is None:
                if not create:
                    return None
                child = type(self)(key)
                node.descendants[key] = child
            node = child
        return node

    # -- iteration -----------------------------------------------------

    def _iter_nodes(self, order="post"):
        """Yield (signal, signal_count, node) for every node incl. self.

        ``signal`` is the block path from (and excluding) the root, except
        that the root itself reports ``(NULL_BLOCK,)`` — the reference's
        convention. Children are visited in insertion order; 'post' visits
        subtrees before the node (node_iterator/leaf_iterator order),
        'pre' the node first (find_uniques order).
        """
        # Explicit stack; entries are (node, signal-of-node, expanded?).
        stack = [(self, (self.signal_block,), False)]
        while stack:
            node, signal, expanded = stack.pop()
            if expanded:
                yield (signal, node.signal_count, node)
                continue
            if order == "pre":
                yield (signal, node.signal_count, node)
            else:
                stack.append((node, signal, True))
            kid_prefix = () if node._is_root() else signal
            for key, child in reversed(list(node.descendants.items())):
                stack.append((child, kid_prefix + (key,), False))

    def node_iterator(self):
        yield from self._iter_nodes(order="post")

    def leaf_iterator(self):
        """Nodes carrying counts, in the same depth-first post-order."""
        for entry in self._iter_nodes(order="post"):
            if len(entry[1]) > 0:
                yield entry

    # -- construction ----------------------------------------------------

    def graft(self, signal, signal_count):
        """Add (accumulate) counts at a signal (MCsimlib.py:1630-1673)."""
        assert len(signal) > 0
        assert signal[0] == self.signal_block or self._is_root()
        assert len(signal_count) > 0
        target = self._follow(self._rel_path(signal), create=True)
        for protein, n in signal_count.items():
            target.signal_count[protein] = \
                target.signal_count.get(protein, 0) + n
        return self

    def get_descendant(self, subsignal):
        if len(subsignal) == 0:
            return None
        return self._follow(self._rel_path(subsignal))

    # merge() lives on the concrete tries (SignalTrie / PolyfluorSignalTrie)
    # which both enforce the reference's root-only contract; a base-class
    # fallback without that assertion would silently relax it.


class SignalTrie(_CountTrieBase):
    """Trie over ((gap, amino_acid), ...) signals
    (MCsimlib.py:1224-1759)."""

    NULL_BLOCK = (None, None)

    def add_descendant(self, subsignal, source_protein):
        subsignal = tuple(tuple(b) for b in subsignal)
        if len(subsignal) == 0:
            return None
        target = self._follow(self._rel_path(subsignal), create=True)
        target.signal_count[source_protein] = \
            target.signal_count.get(source_protein, 0) + 1
        return self

    def set_descendant(self, subsignal, count):
        if len(subsignal) == 0:
            return None
        target = self._follow(self._rel_path(subsignal), create=True)
        target.signal_count = count.copy()
        return self

    def pop_node(self, prefix_signal=()):
        """Detach and return the first childless node on the first-child
        chain (MCsimlib.py:1534-1558)."""
        node, path = self, tuple(prefix_signal)
        while True:
            key, child = next(iter(node.descendants.items()))
            path = path + (key,)
            if len(child.descendants) == 0:
                del node.descendants[key]
                return path, child
            node = child

    @staticmethod
    def _top_two(signal_count):
        """(best, second) (protein, count) pairs under the reference's
        one-pass scan semantics (a tie for best stays in second)."""
        best = (None, 0)
        second = (None, 0)
        for protein, count in signal_count.items():
            if count > best[1]:
                best = (protein, count)
            elif count > second[1]:
                second = (protein, count)
        return best, second

    def _collect_uniques(self, qualifies):
        """Shared scaffold of find_uniques/find_uniques_absolute: visit
        nodes root-first (reference recursion order), apply the
        qualification predicate to (best, second), and build the
        {signal: [best, [runners-up...], below_second_total]} report."""
        uniques = {}
        for signal, counts, _node in self._iter_nodes(order="pre"):
            if len(counts) == 0:
                continue
            best, second = self._top_two(counts)
            if not qualifies(best, second):
                continue
            entry = [best, [second], 0]
            for protein, count in counts.items():
                if count == second[1] and protein != second[0]:
                    entry[1].append((protein, count))
                elif count < second[1]:
                    entry[2] += count
            uniques.setdefault(signal, entry)
        return uniques

    def find_uniques(self, worst_ratio, absolute_min, maximum_secondary=None):
        """Signals dominated by one protein (MCsimlib.py:1398-1486)."""

        def qualifies(best, second):
            if best[1] < absolute_min:
                return False
            if worst_ratio is None:
                ratio_ok = second[0] is None
            else:
                ratio_ok = (second[1] == 0 or
                            float(best[1]) / second[1] >= worst_ratio)
            if not ratio_ok:
                return False
            return (maximum_secondary is None or second[0] is None or
                    second[1] <= maximum_secondary)

        return self._collect_uniques(qualifies)

    def find_uniques_absolute(self, minimum_best, maximum_secondary):
        """Absolute-count unique criterion (MCsimlib.py:1487-1532)."""
        return self._collect_uniques(
            lambda best, second: (best[1] >= minimum_best and
                                  second[1] <= maximum_secondary))

    def count_nodes(self):
        empty = used = 0
        for _signal, counts, _node in self._iter_nodes(order="post"):
            if len(counts) == 0:
                empty += 1
            else:
                used += 1
        return empty, used

    def prune(self, signal):
        """Remove a signal, returning (signal, its counts)
        (MCsimlib.py:1560-1629)."""
        assert len(signal) > 0
        if self._is_root():
            assert len(signal) == 1 or signal[0] in self.descendants
        else:
            assert len(signal) > 1
            assert signal[0] == self.signal_block
            assert signal[1] in self.descendants
        path = self._rel_path(signal)
        parent = self._follow(path[:-1])
        target = parent.descendants[path[-1]]
        if len(target.descendants) == 0:
            del parent.descendants[path[-1]]
            return (tuple(signal), target.signal_count)
        counts = target.signal_count
        target.signal_count = {}
        return (tuple(signal), counts)

    def merge(self, trie, cycles=None):
        assert self._is_root(), "merge can only be called on the root node"
        for leaf in trie.leaf_iterator():
            if cycles is None or leaf[0][-1][0] <= cycles:
                self.graft(leaf[0], leaf[1])
        return self

    def truncating_projection(self, cycles):
        """Project signals onto a truncated cycle count
        (MCsimlib.py:1697-1759): re-graft projections of too-long leaves,
        then delete beyond-cycles subtrees and leafless branches."""
        for signal, counts, _node in list(self.leaf_iterator()):
            if signal[-1][0] > cycles:
                projected = tuple(b for b in signal if b[0] <= cycles)
                if projected:
                    self.graft(projected, counts)
        # Drop children whose first block exceeds the cycle horizon, from
        # every surviving (within-horizon) node.
        stale = [(node, key)
                 for signal, _counts, node in self._iter_nodes(order="post")
                 for key in node.descendants
                 if signal[-1][0] is not None and signal[-1][0] <= cycles and
                 key[0] > cycles]
        for node, key in stale:
            if key in node.descendants:
                del node.descendants[key]
        # Drop branches that no longer contain any counted node: the
        # reference checks the children of count-carrying nodes and of the
        # root itself.
        barren = []
        for _signal, counts, node in self._iter_nodes(order="post"):
            if len(counts) == 0 and node is not self:
                continue
            for key, child in node.descendants.items():
                if not any(True for _ in child.leaf_iterator()):
                    barren.append((node, key))
        for node, key in barren:
            if key in node.descendants:
                del node.descendants[key]
        return self


class SlimSignalTrie:
    """Signal -> protein-set trie (MCsimlib.py:1761-1785).

    Unlike SignalTrie, every subsignal element is a child key (no
    self-naming element), and the root carries no block."""

    def __init__(self):
        self.descendants = {}
        self.proteins = set()

    def add_proteins(self, subsignal, proteins):
        node = self
        for key in subsignal:
            node = node.descendants.setdefault(key, SlimSignalTrie())
        node.proteins |= proteins

    def get_proteins(self, subsignal):
        node = self
        for key in subsignal:
            node = node.descendants.get(key)
            if node is None:
                return set()
        return node.proteins

    def compact_proteins(self, threshold=1):
        """Collapse protein sets to a bool. Reference quirk preserved
        (MCsimlib.py:1781-1785): the recursion drops the threshold, so
        descendants always compact with the DEFAULT threshold of 1."""
        self.proteins = len(self.proteins) > threshold
        stack = list(self.descendants.values())
        while stack:
            node = stack.pop()
            node.proteins = len(node.proteins) > 1
            stack.extend(node.descendants.values())


class PolyfluorSignalTrie(_CountTrieBase):
    """Trie over error-annotated PolyfluorSignals (MCsimlib.py:2223-2310).

    Same addressing as SignalTrie but with 3-element blocks and WITHOUT
    the block canonicalization on add (the reference stores the caller's
    objects as-is)."""

    NULL_BLOCK = (None, None, None)

    def add_descendant(self, subsignal, source_protein):
        if len(subsignal) == 0:
            return None
        target = self._follow(self._rel_path(subsignal), create=True)
        target.signal_count[source_protein] = \
            target.signal_count.get(source_protein, 0) + 1
        return self

    def isoerr_get_descendant(self, subsignal):
        """Unfinished stub in the reference (MCsimlib.py:2274-2277): strips
        error annotations then falls through returning None — kept as-is."""
        if len(subsignal) == 0:
            return
        subsignal = [s[:2] for s in subsignal]

    def merge(self, trie):
        if not self._is_root():
            raise Exception("merge can only be called on root node.")
        for leaf in trie.leaf_iterator():
            self.graft(leaf[0], leaf[1])
        return self
