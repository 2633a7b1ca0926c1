"""GraphView: a read-only index over a Symbol DAG for analysis passes.

Counterpart of ``mxnet_tpu/analysis/graph.py``.

``symbol._topo`` assumes a well-formed DAG (it marks nodes *before*
visiting inputs, so on a cyclic graph it silently returns a wrong
order instead of looping).  Analysis must not trust the graph it is
checking, so this module owns a tricolor DFS that detects cycles first;
every later pass runs only on graphs the traversal certified acyclic.
"""
from __future__ import annotations

from ..symbol.symbol import _topo

__all__ = ["GraphView", "find_cycle", "splice_input", "redirect_entries"]


def splice_input(node, slot, entry):
    """Point input ``slot`` of ``node`` at ``entry`` ((SymNode, out_idx)).

    The edge-level splice the repair engine uses to interpose a mask
    node between a producer and one specific consumer: other consumers
    of the producer keep reading the unmasked value.
    """
    if not (0 <= slot < len(node.inputs)):
        raise IndexError("node %r has %d inputs, no slot %d"
                         % (node.name, len(node.inputs), slot))
    node.inputs[slot] = tuple(entry)


def redirect_entries(symbol, replacements):
    """Re-point every consumer edge AND head of ``symbol`` matching a
    key of ``replacements`` ({(id(node), out_idx): (new_node, out_idx)})
    at its replacement entry.

    This is the node-replacement primitive (the mean -> sum/count
    rewrite): build the replacement subgraph reading the OLD node's
    inputs first, then redirect; the old node drops out of the DAG once
    nothing reaches it.  Mutates ``symbol`` in place.
    """
    for n in _topo(symbol._outputs):
        n.inputs = [tuple(replacements.get((id(i), ix), (i, ix)))
                    for (i, ix) in n.inputs]
    symbol._outputs = [tuple(replacements.get((id(n), ix), (n, ix)))
                       for (n, ix) in symbol._outputs]


def find_cycle(heads):
    """Tricolor DFS over ``(SymNode, out_idx)`` heads.

    Returns a list of node names forming a cycle (closed: first ==
    last), or None when the graph is acyclic.  Iterative, so a deep or
    cyclic graph cannot blow the Python stack.
    """
    WHITE, GREY, BLACK = 0, 1, 2
    color = {}
    stack = []          # (node, input cursor)
    for (head, _) in heads:
        if color.get(id(head), WHITE) is not WHITE:
            continue
        stack.append([head, 0])
        color[id(head)] = GREY
        while stack:
            node, cursor = stack[-1]
            if cursor < len(node.inputs):
                stack[-1][1] += 1
                child = node.inputs[cursor][0]
                c = color.get(id(child), WHITE)
                if c == GREY:
                    # unwind the grey chain back to `child` for the trace
                    names = [child.name]
                    for frame in reversed(stack):
                        names.append(frame[0].name)
                        if frame[0] is child:
                            break
                    names.reverse()
                    return names
                if c == WHITE:
                    color[id(child)] = GREY
                    stack.append([child, 0])
            else:
                color[id(node)] = BLACK
                stack.pop()
    return None


class GraphView(object):
    """Indexes one Symbol: topo order, producer paths, per-node lookups.

    Build only after :func:`find_cycle` returned None (the verifier does
    this); constructors of downstream passes receive the certified view.
    """

    def __init__(self, symbol):
        self.symbol = symbol
        self.heads = list(symbol._outputs)
        self.topo = _topo(self.heads)
        self.node_index = {id(n): i for i, n in enumerate(self.topo)}
        # first producer edge into each node, for provenance unwinding
        self._feeder = {}
        for n in self.topo:
            for (inp, _) in n.inputs:
                self._feeder.setdefault(id(n), inp)

    # ------------------------------------------------------------------
    def variables(self):
        return [n for n in self.topo if n.op is None]

    def op_nodes(self):
        return [n for n in self.topo if n.op is not None]

    def provenance(self, node, limit=6):
        """Dataflow path from a graph input variable to ``node``:
        ``['data', 'conv0', 'fc1']``.  Follows first-input edges (the
        data spine by MXNet convention: input 0 is `data`/`lhs`), which
        is how a reader traces "flowing from `data` via `conv0`"."""
        path = [node.name]
        cur = node
        seen = {id(node)}
        while True:
            nxt = self._feeder.get(id(cur))
            if nxt is None or id(nxt) in seen:
                break
            path.append(nxt.name)
            seen.add(id(nxt))
            cur = nxt
        path.reverse()
        if len(path) > limit:
            path = path[:2] + ["..."] + path[-(limit - 3):]
        return path
