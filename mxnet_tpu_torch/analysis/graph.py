"""Graph-surgery primitive (counterpart of ``redirect_entries`` in
``mxnet_tpu/analysis/graph.py``)."""

from ..symbol.symbol import _topo

__all__ = ["redirect_entries"]


def redirect_entries(symbol, replacements):
    """Re-point every consumer edge AND head of ``symbol`` matching a key
    of ``replacements`` ({(id(node), out_idx): (new_node, out_idx)}) at
    its replacement entry.  The old node drops out of the DAG once nothing
    reaches it.  Mutates ``symbol`` in place."""
    for n in _topo(symbol._outputs):
        n.inputs = [tuple(replacements.get((id(i), ix), (i, ix)))
                    for (i, ix) in n.inputs]
    symbol._outputs = [tuple(replacements.get((id(n), ix), (n, ix)))
                       for (n, ix) in symbol._outputs]
