"""Symbol: declarative graph construction.

Counterpart of ``mxnet_tpu/symbol/symbol.py``.  A Symbol is a list of
output entries over a DAG of (op, attrs, inputs) nodes.  Its JSON keeps
the reference's node-list layout (op/"null", name, attrs as strings,
inputs as [node_id, out_idx, version]) and is written exactly as the JAX
package writes it, so the two packages load each other's
``-symbol.json``.  Shape and type inference run each op on meta tensors;
``infer_shape_partial`` stops where shapes are unknown instead of
raising.  Variables carry the reference's ``__shape__``, ``__dtype__``,
``__lr_mult__``, ``__wd_mult__`` and ``__init__`` attributes.
"""
from __future__ import annotations

import json

import numpy as np

from ..base import MXNetError, NameManager, AttrScope, attrs_to_strings, \
    _parse_tuple
from ..ops import get_op
from ..ops.registry import OpDef, dtype_name

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "copy_graph", "zeros", "ones"]


class SymNode:
    """One graph node (op node, or variable when ``op`` is None)."""
    __slots__ = ("op", "name", "attrs", "inputs")

    def __init__(self, op, name, attrs=None, inputs=None):
        self.op = op
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs or [])    # list of (SymNode, out_index)

    def num_outputs(self):
        return 1 if self.op is None else self.op.num_outputs(self.attrs)

    def __repr__(self):
        return "<SymNode %s %s>" % (self.op.name if self.op else "var",
                                    self.name)


def _topo(heads):
    """Topological order of the nodes reachable from head entries."""
    seen = set()
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for (inp, _) in node.inputs:
            visit(inp)
        order.append(node)

    for (n, _) in heads:
        visit(n)
    return order


class Symbol:
    """A list of output entries over a shared DAG."""

    def __init__(self, outputs):
        self._outputs = list(outputs)      # list of (SymNode, out_idx)

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group[%d]" % len(self._outputs))

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, index):
        """Output ``index`` (a position, a slice or an output name) as a
        Symbol of its own."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %r not found in %s" % (index, names))
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return copy_graph(self)[0]

    def get_internals(self):
        """A Symbol of every node's every output, in topological order."""
        return Symbol([(n, i) for n in _topo(self._outputs)
                       for i in range(n.num_outputs())])

    def get_children(self):
        """The inputs of this symbol's node as a Symbol, None for a
        variable."""
        if len(self._outputs) != 1 or not self._outputs[0][0].inputs:
            return None
        return Symbol(list(self._outputs[0][0].inputs))

    # -- listing -----------------------------------------------------------
    def list_outputs(self):
        names = []
        for (node, idx) in self._outputs:
            if node.op is None:
                names.append(node.name)
            elif node.num_outputs() == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, idx))
        return names

    def _aux_nodes(self):
        aux = set()
        for node in _topo(self._outputs):
            if node.op is None:
                continue
            for ai in node.op.aux_inputs:
                if ai < len(node.inputs):
                    inp, _ = node.inputs[ai]
                    if inp.op is None:
                        aux.add(id(inp))
        return aux

    def list_arguments(self):
        aux = self._aux_nodes()
        return [n.name for n in _topo(self._outputs)
                if n.op is None and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = self._aux_nodes()
        return [n.name for n in _topo(self._outputs)
                if n.op is None and id(n) in aux]

    def list_inputs(self):
        """Every variable, arguments and aux states, in topological
        order."""
        return [n.name for n in _topo(self._outputs) if n.op is None]

    def attr(self, key):
        """Attribute ``key`` of this symbol's node, None if it has none."""
        if len(self._outputs) != 1:
            return None
        v = self._outputs[0][0].attrs.get(key)
        return None if v is None else attrs_to_strings({key: v})[key]

    def _set_attr(self, **kwargs):
        for node, _ in self._outputs:
            node.attrs.update(kwargs)

    # -- shape inference ----------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the known input
        shapes; raises naming the first node it could not get past."""
        return self._infer_shape(False, args, kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """``infer_shape`` that leaves None where a shape stays unknown."""
        return self._infer_shape(True, args, kwargs)

    def _infer_shape(self, partial, args, kwargs):
        known = {}
        for n, s in zip(self.list_arguments(), args):
            if s is not None:
                known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes = infer_graph_env(self._outputs, known, partial=partial)[0]
        topo = _topo(self._outputs)
        aux = self._aux_nodes()
        arg_shapes = [shapes.get((id(n), 0)) for n in topo
                      if n.op is None and id(n) not in aux]
        aux_shapes = [shapes.get((id(n), 0)) for n in topo
                      if n.op is None and id(n) in aux]
        out_shapes = [shapes.get((id(n), i)) for (n, i) in self._outputs]
        if not partial and any(s is None for s in
                               arg_shapes + aux_shapes + out_shapes):
            missing = [nm for nm, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            blocked = ""
            for n in topo:
                if n.op is not None and not all(
                        (id(n), i) in shapes
                        for i in range(n.num_outputs())):
                    unknown = [inp.name for (inp, ix) in n.inputs
                               if (id(inp), ix) not in shapes]
                    blocked = "; first blocked node %r (%s) waiting on " \
                              "input(s) %s" % (n.name, n.op.name, unknown)
                    break
            raise MXNetError("infer_shape: incomplete; unknown args %s%s"
                             % (missing, blocked))
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """(arg_types, out_types, aux_types) as numpy dtypes from the
        known input types (a variable's ``__dtype__``, else float32); an
        output whose shapes are unknown is taken as float32, as the
        reference takes it."""
        known = {}
        for n, t in zip(self.list_arguments(), args):
            if t is not None:
                known[n] = t
        known.update({k: v for k, v in kwargs.items() if v is not None})
        dtypes = infer_graph_env(self._outputs, {}, known, partial=True)[1]
        topo = _topo(self._outputs)
        aux = self._aux_nodes()

        def np_dtype(key):
            d = dtypes.get(key)
            return np.dtype(np.float32) if d is None \
                else np.dtype(dtype_name(d))
        arg_types = [np_dtype((id(n), 0)) for n in topo
                     if n.op is None and id(n) not in aux]
        aux_types = [np_dtype((id(n), 0)) for n in topo
                     if n.op is None and id(n) in aux]
        out_types = [np_dtype(k) for k in self._outputs]
        return arg_types, out_types, aux_types

    # -- arithmetic composition ----------------------------------------------
    def _binary(self, other, op, scalar_op, rscalar_op=None, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(op, [a, b], {})
        if isinstance(other, (int, float, np.number, bool)):
            name = rscalar_op if reverse and rscalar_op else scalar_op
            return _create(name, [self], {"scalar": float(other)})
        raise TypeError("cannot combine Symbol with %s" % type(other))

    def __add__(self, o):
        return self._binary(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "elemwise_sub", "_minus_scalar",
                            "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "elemwise_div", "_div_scalar",
                            "_rdiv_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "_power", "_power_scalar", "_rpow_scalar",
                            reverse=True)

    def __mod__(self, o):
        return self._binary(o, "_mod", "_mod_scalar")

    def __neg__(self):
        return _create("negative", [self], {})

    def __eq__(self, o):
        return self._binary(o, "equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "greater_equal", "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # -- serialization ------------------------------------------------------
    def tojson(self):
        topo = _topo(self._outputs)
        nid = {id(n): i for i, n in enumerate(topo)}
        nodes = [{"op": "null" if n.op is None else n.op.name,
                  "name": n.name,
                  "attrs": attrs_to_strings(n.attrs),
                  "inputs": [[nid[id(i)], ix, 0] for (i, ix) in n.inputs]}
                 for n in topo]
        arg_nodes = [i for i, n in enumerate(topo) if n.op is None]
        heads = [[nid[id(n)], ix, 0] for (n, ix) in self._outputs]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 1200]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def attr_dict(self):
        """{name: {attr: string}} of every node that has attributes."""
        return {n.name: attrs_to_strings(n.attrs)
                for n in _topo(self._outputs) if n.attrs}

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req="write", **shapes):
        """Bind to zero-filled float32 arguments and aux states of the
        shapes inferred from the given input shapes, with gradient arrays
        per ``grad_req``."""
        from ..executor import Executor
        from ..ndarray import zeros
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        args = {n: zeros(s, ctx) for n, s in zip(self.list_arguments(),
                                                  arg_shapes)}
        aux = {n: zeros(s, ctx) for n, s in
               zip(self.list_auxiliary_states(), aux_shapes)}
        return Executor(self, ctx, args, None, grad_req, aux)


def copy_graph(symbol):
    """Structural deep copy of the DAG behind ``symbol``: (clone,
    {id(old node): new node}).  Edits to the clone never touch the
    source graph."""
    mapping = {}
    for n in _topo(symbol._outputs):
        mapping[id(n)] = SymNode(n.op, n.name, dict(n.attrs),
                                 [(mapping[id(i)], ix)
                                  for (i, ix) in n.inputs])
    return Symbol([(mapping[id(n)], ix) for (n, ix) in symbol._outputs]), \
        mapping


def infer_graph_env(heads, known_shapes, known_dtypes=None, partial=False):
    """Forward fixed point over the DAG: variables seed shapes (and
    dtypes: ``known_dtypes``, else the variable's ``__dtype__``, else
    float32), each op's ``fill_shapes`` completes its parameter shapes,
    then the op runs on meta tensors for its output shapes and dtypes.
    With ``partial`` an op that fails is left unknown instead of raising.
    Returns ({(id(node), out_idx): shape}, {...: torch dtype})."""
    from ..ops.registry import torch_dtype
    topo = _topo(heads)
    shapes, dtypes = {}, {}
    for n in topo:
        if n.op is None:
            dtypes[(id(n), 0)] = torch_dtype(
                (known_dtypes or {}).get(n.name)
                or n.attrs.get("__dtype__") or "float32")
            if n.name in known_shapes:
                shapes[(id(n), 0)] = tuple(known_shapes[n.name])
            elif "__shape__" in n.attrs:
                shapes[(id(n), 0)] = tuple(n.attrs["__shape__"])
    for _pass in range(max(3, len(topo))):
        progressed = False
        for n in topo:
            if n.op is None or all((id(n), i) in shapes
                                   for i in range(n.num_outputs())):
                continue
            attrs = n.op.normalize({k: v for k, v in n.attrs.items()
                                    if not k.startswith("__")})
            keys = [(id(i), ix) for (i, ix) in n.inputs]
            in_shapes = [shapes.get(k) for k in keys]
            if n.op.fill_shapes is not None:
                filled = n.op.fill_shapes(attrs, list(in_shapes))
                for k, old, new in zip(keys, in_shapes, filled):
                    if old is None and new is not None:
                        shapes[k] = tuple(new)
                        progressed = True
                in_shapes = [shapes.get(k) for k in keys]
            if any(s is None for s in in_shapes):
                continue
            try:
                _, out_shapes, out_dtypes = n.op.infer(
                    attrs, in_shapes, [dtypes.get(k) for k in keys])
            except Exception as e:
                if partial:
                    continue
                raise MXNetError("shape inference failed at %s(%s): %s"
                                 % (n.op.name, n.name, e))
            for i, (s, d) in enumerate(zip(out_shapes, out_dtypes)):
                shapes[(id(n), i)] = s
                dtypes[(id(n), i)] = d
            progressed = True
        if not progressed:
            break
    return shapes, dtypes


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """A variable; ``shape``, ``dtype``, ``lr_mult``, ``wd_mult`` and
    ``init`` (a name, or an initializer's JSON) become its ``__shape__``,
    ``__dtype__``, ``__lr_mult__``, ``__wd_mult__`` and ``__init__``
    attributes, as in the reference."""
    attrs = AttrScope.current().get(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = float(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = float(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update(kwargs)
    return Symbol([(SymNode(None, name, attrs, []), 0)])


Variable = var


def Group(symbols):
    return Symbol([o for s in symbols for o in s._outputs])


def _create(op_name, input_syms, attrs, name=None):
    """Create an op node from symbols, inventing missing parameter
    variables as ``<name>_<input>`` (the reference's behaviour)."""
    opdef = op_name if isinstance(op_name, OpDef) else get_op(op_name)
    name = NameManager.current().get(name, opdef.name.lower().replace("_", ""))
    scope_attrs = AttrScope.current().get({})
    entries = []
    for s in input_syms:
        if len(s._outputs) != 1:
            # a multi-output symbol used as one input composes through its
            # primary visible output (e.g. BatchNorm's `out`)
            node0 = s._outputs[0][0]
            nvis = node0.op.num_visible_outputs if node0.op else 1
            if callable(nvis):
                nvis = nvis(node0.attrs)
            if all(n is node0 for (n, _) in s._outputs) and nvis == 1:
                entries.append(s._outputs[0])
                continue
            raise MXNetError("op %s: cannot take multi-output symbol as one "
                             "input" % opdef.name)
        entries.append(s._outputs[0])
    norm = opdef.normalize(dict(attrs))
    expected = opdef.input_names(norm, num_inputs=len(entries))
    for miss in expected[len(entries):]:
        entries.append(var("%s_%s" % (name, miss))._outputs[0])
    keep = dict(norm)
    if opdef.variable_inputs and opdef.key_var_num_args:
        keep[opdef.key_var_num_args] = len(entries)
    keep.update({k: v for k, v in scope_attrs.items() if k.startswith("__")})
    node = SymNode(opdef, name, keep, entries)
    return Symbol([(node, i) for i in range(node.num_outputs())])


def zeros(shape, dtype=None, **kwargs):
    return _create("_zeros", [], {"shape": (shape,) if isinstance(shape, int)
                                  else tuple(shape),
                                  "dtype": np.dtype(dtype or np.float32).name})


def ones(shape, dtype=None, **kwargs):
    return _create("_ones", [], {"shape": (shape,) if isinstance(shape, int)
                                 else tuple(shape),
                                 "dtype": np.dtype(dtype or np.float32).name})


# ---------------------------------------------------------------------------
# deserialization
# ---------------------------------------------------------------------------

def load_json(json_str):
    data = json.loads(json_str)
    built = []
    for nj in data["nodes"]:
        raw = nj.get("attrs", nj.get("param", {})) or {}
        if nj["op"] == "null":
            attrs = dict(raw)
            if isinstance(attrs.get("__shape__"), str):
                attrs["__shape__"] = _parse_tuple(attrs["__shape__"], int)
            node = SymNode(None, nj["name"], attrs, [])
        else:
            opdef = get_op(nj["op"])
            inputs = [(built[i], ix) for (i, ix, *_) in nj["inputs"]]
            attrs = opdef.normalize({k: v for k, v in raw.items()
                                     if not k.startswith("__")})
            attrs.update({k: v for k, v in raw.items()
                          if k.startswith("__")})
            node = SymNode(opdef, nj["name"], attrs, inputs)
        built.append(node)
    return Symbol([(built[i], ix) for (i, ix, *_) in data["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())
