"""The optimizer's fused-op SELECTION pass over the Symbol IR.

Counterpart of the ``select`` pass of ``mxnet_tpu/analysis/optimize.py``
and the pipeline state it needs (the other passes there, ``algebraic``,
``fold``, ``cse``, ``dce`` and ``fuse``, are not ported).  It matches
subgraphs that state a dedicated kernel's semantics the long way and
swaps in the registry op that says it directly:

- the one-hot-blend KV-cache row write
  ``cache*(1-oh[...,None]) + row[:,None,:]*oh[...,None]`` with
  ``oh = one_hot(pos, max_len)``, O(max_len*d) per token, becomes
  ``_cache_write_row(cache, row, pos)`` (K9, O(d));
- the speculative commit's chain of K count-masked blends
  (serving/spec.py ``build_commit_sym``) becomes
  ``_cache_write_rows(cache, rows, pos, count)`` (K10).

Adoption: the reference adopts a plan only through its verdict gate
(re-analysis no worse, slot-axis row-locality preserved under pad-dirty
seeding, ``mxnet_tpu/analysis/padding.py``).  That gate is not ported.
Here a plan is adopted whenever the matcher proves the exact blend
pattern and re-inference shows the outputs' count, shapes and dtypes
unchanged; ``OptPlan.gate`` says so, and the decode engine's ``stats()``
repeats it.  Orphaned blend nodes need no sweep: a Symbol is what its
outputs reach.
"""
from __future__ import annotations

import collections

from ..base import MXNetError
from ..ops import get_op
from ..symbol.symbol import SymNode, copy_graph, _topo, infer_graph_env
from .graph import redirect_entries

__all__ = ["OptAction", "OptPlan", "OptState", "optimize_graph",
           "SELECT_OPT_PASSES"]

#: the kernel-selection pipeline (the reference's SELECT_OPT_PASSES runs
#: its default passes after this one; only the selection is ported)
SELECT_OPT_PASSES = ("select",)

#: what adopted a plan: the reference's padding verdict gate is not ported
GATE = ("pattern match + output signature (the reference's padding "
        "verdict gate is not ported)")

#: one planned rewrite: ``kind`` is "select" for a kernel selection
OptAction = collections.namedtuple(
    "OptAction", ["pass_name", "kind", "node", "op", "detail"])


class OptState(object):
    """Mutable state threaded through the pass: the working clone, its
    shape/dtype environment ((id(node), out_idx) -> shape / torch dtype,
    extended for nodes the pass creates), the action log and the names
    taken."""

    def __init__(self, symbol, shapes, dtypes):
        self.symbol = symbol
        self.shapes = shapes
        self.dtypes = dtypes
        self.actions = []
        self.attr = {}              # id(node) -> pass that disconnected it
        self.taken = set(n.name for n in _topo(symbol._outputs))

    def track(self, node, shape=None, dtype=None):
        """Register a pass-created node with the environment."""
        self.taken.add(node.name)
        if shape is not None:
            self.shapes[(id(node), 0)] = tuple(shape)
        if dtype is not None:
            self.dtypes[(id(node), 0)] = dtype
        return node

    def record(self, pass_name, kind, node, detail):
        self.actions.append(OptAction(
            pass_name, kind, node.name,
            node.op.name if node.op else None, detail))

    def sig(self, entry):
        key = (id(entry[0]), entry[1])
        return self.shapes.get(key), self.dtypes.get(key)


def _unique_name(taken, base):
    if base not in taken:
        taken.add(base)
        return base
    i = 0
    while "%s%d" % (base, i) in taken:
        i += 1
    name = "%s%d" % (base, i)
    taken.add(name)
    return name


def _resolve(repl, entry):
    """Follow a replacement chain to its terminal entry."""
    seen = set()
    while True:
        key = (id(entry[0]), entry[1])
        nxt = repl.get(key)
        if nxt is None or key in seen:
            return entry
        seen.add(key)
        entry = nxt


def _apply(state, repl):
    if not repl:
        return
    flat = {k: _resolve(repl, v) for k, v in repl.items()}
    redirect_entries(state.symbol, flat)


def _norm(node):
    try:
        return node.op.normalize(node.attrs)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# fused-op selection
# ---------------------------------------------------------------------------

def _entry_key(e):
    return (id(e[0]), e[1])


def _match_kv_write(state, n):
    """Match the one-hot-blend KV-cache row write rooted at ``n``
    (an ``_add``)::

        ohe  = expand_dims(one_hot(pos, depth=T, on=1, off=0), axis=2)
        n    = cache * (1.0 - ohe)  +  expand_dims(row, axis=1) * ohe

    with ``cache (N, T) + tail``, ``row (N,) + tail``, ``pos (N,)``,
    the SAME ``ohe`` entry on both sides, and ``depth == T``.  Both
    add operand orders and both mul operand orders are tried (the mul
    family is commutative).  Returns ``(cache_entry, row_entry,
    pos_entry)`` or None.
    """
    if n.op is None or n.op.name != "_add" or len(n.inputs) != 2:
        return None
    for ka in (0, 1):
        m = _match_kv_sides(state, n.inputs[ka], n.inputs[1 - ka])
        if m is not None:
            return m
    return None


def _match_kv_sides(state, keep_e, write_e):
    keep, write = keep_e[0], write_e[0]
    if keep_e[1] != 0 or write_e[1] != 0:
        return None
    for node in (keep, write):
        if node.op is None or node.op.name != "_mul" \
                or len(node.inputs) != 2:
            return None
    for wi in (0, 1):
        ohe_e, rowx_e = write.inputs[wi], write.inputs[1 - wi]
        ohe = ohe_e[0]
        if ohe.op is None or ohe.op.name != "expand_dims" \
                or ohe_e[1] != 0:
            continue
        oattrs = _norm(ohe)
        oh_e = ohe.inputs[0]
        oh = oh_e[0]
        if oattrs is None or oh.op is None or oh.op.name != "one_hot" \
                or oh_e[1] != 0:
            continue
        oh_shape = state.shapes.get(_entry_key(oh_e))
        if oh_shape is None or len(oh_shape) != 2:
            continue
        ax = int(oattrs.get("axis", 0))
        if (ax + 3 if ax < 0 else ax) != 2:
            continue
        hattrs = _norm(oh)
        if hattrs is None \
                or float(hattrs.get("on_value", 1.0)) != 1.0 \
                or float(hattrs.get("off_value", 0.0)) != 0.0:
            continue
        depth = int(hattrs["depth"])
        pos_e = oh.inputs[0]
        rowx = rowx_e[0]
        if rowx.op is None or rowx.op.name != "expand_dims" \
                or rowx_e[1] != 0:
            continue
        rattrs = _norm(rowx)
        row_e = rowx.inputs[0]
        row_shape = state.shapes.get(_entry_key(row_e))
        if rattrs is None or row_shape is None:
            continue
        rax = int(rattrs.get("axis", 0))
        if rax < 0:
            rax += len(row_shape) + 1
        if rax != 1:
            continue
        for ki in (0, 1):
            inv_e, cache_e = keep.inputs[ki], keep.inputs[1 - ki]
            inv = inv_e[0]
            if inv.op is None or inv.op.name != "_rminus_scalar" \
                    or inv_e[1] != 0:
                continue
            iattrs = _norm(inv)
            if iattrs is None \
                    or float(iattrs.get("scalar", 0.0)) != 1.0:
                continue
            if _entry_key(inv.inputs[0]) != _entry_key(ohe_e):
                continue        # both sides must blend the SAME mask
            cshape = state.shapes.get(_entry_key(cache_e))
            pshape = state.shapes.get(_entry_key(pos_e))
            if cshape is None or pshape is None or len(cshape) < 2:
                continue
            if cshape[1] != depth or oh_shape != (cshape[0], depth) \
                    or pshape != (cshape[0],) \
                    or row_shape != (cshape[0],) + tuple(cshape[2:]):
                continue
            return cache_e, row_e, pos_e
    return None


def _match_masked_blend(state, n):
    """Match ONE count-masked one-hot blend — the speculative commit
    builder's per-position write (serving/spec.py)::

        ohe  = expand_dims(one_hot(pos + j, T) *
                           expand_dims(count > j, 1), axis=2)
        n    = prev * (1 - ohe)  +  slice_axis(rows, 1, j, j+1) * ohe

    Returns ``(prev_entry, rows_entry, pos_entry, count_entry, j, T)``
    or None.  ``pos + 0`` may appear as a bare ``pos`` entry (the
    builder emits ``_plus_scalar`` uniformly, but an algebraic bypass
    in a later fixed-point iteration may have collapsed it)."""
    if n.op is None or n.op.name != "_add" or len(n.inputs) != 2:
        return None
    for ka in (0, 1):
        keep_e, write_e = n.inputs[ka], n.inputs[1 - ka]
        keep, write = keep_e[0], write_e[0]
        if keep_e[1] != 0 or write_e[1] != 0:
            continue
        if any(x.op is None or x.op.name != "_mul"
               or len(x.inputs) != 2 for x in (keep, write)):
            continue
        for wi in (0, 1):
            ohe_e, rowx_e = write.inputs[wi], write.inputs[1 - wi]
            ohe = ohe_e[0]
            if ohe.op is None or ohe.op.name != "expand_dims" \
                    or ohe_e[1] != 0:
                continue
            oattrs = _norm(ohe)
            if oattrs is None:
                continue
            ax = int(oattrs.get("axis", 0))
            if (ax + 3 if ax < 0 else ax) != 2:
                continue
            ohm_e = ohe.inputs[0]
            ohm = ohm_e[0]
            if ohm.op is None or ohm.op.name != "_mul" \
                    or ohm_e[1] != 0 or len(ohm.inputs) != 2:
                continue
            for mi in (0, 1):
                oh_e, mje_e = ohm.inputs[mi], ohm.inputs[1 - mi]
                oh, mje = oh_e[0], mje_e[0]
                if oh.op is None or oh.op.name != "one_hot" \
                        or oh_e[1] != 0:
                    continue
                hattrs = _norm(oh)
                if hattrs is None \
                        or float(hattrs.get("on_value", 1.0)) != 1.0 \
                        or float(hattrs.get("off_value", 0.0)) != 0.0:
                    continue
                depth = int(hattrs["depth"])
                # position: pos + j (or bare pos for j == 0)
                pj = oh.inputs[0]
                if pj[0].op is not None \
                        and pj[0].op.name == "_plus_scalar" \
                        and pj[1] == 0:
                    pattrs = _norm(pj[0])
                    if pattrs is None:
                        continue
                    j_pos = float(pattrs.get("scalar", 0.0))
                    pos_e = pj[0].inputs[0]
                else:
                    j_pos = 0.0
                    pos_e = pj
                if j_pos != int(j_pos) or j_pos < 0:
                    continue
                # mask: expand_dims(count > j, axis=1)
                if mje.op is None or mje.op.name != "expand_dims" \
                        or mje_e[1] != 0:
                    continue
                mattrs = _norm(mje)
                if mattrs is None:
                    continue
                max_ = int(mattrs.get("axis", 0))
                if (max_ + 2 if max_ < 0 else max_) != 1:
                    continue
                mj_e = mje.inputs[0]
                mj = mj_e[0]
                if mj.op is None or mj.op.name != "_greater_scalar" \
                        or mj_e[1] != 0:
                    continue
                gattrs = _norm(mj)
                if gattrs is None \
                        or float(gattrs.get("scalar", 0.0)) != j_pos:
                    continue
                count_e = mj.inputs[0]
                # write row: slice_axis(rows, axis=1, j, j+1)
                rowx = rowx_e[0]
                if rowx.op is None or rowx.op.name != "slice_axis" \
                        or rowx_e[1] != 0:
                    continue
                rattrs = _norm(rowx)
                if rattrs is None or int(rattrs.get("axis", 0)) != 1 \
                        or int(rattrs.get("begin", 0)) != int(j_pos) \
                        or rattrs.get("end") is None \
                        or int(rattrs["end"]) != int(j_pos) + 1:
                    continue
                rows_e = rowx.inputs[0]
                # keep side: prev * (1 - ohe), the SAME ohe entry
                for ki in (0, 1):
                    inv_e, prev_e = keep.inputs[ki], keep.inputs[1 - ki]
                    inv = inv_e[0]
                    if inv.op is None \
                            or inv.op.name != "_rminus_scalar" \
                            or inv_e[1] != 0:
                        continue
                    iattrs = _norm(inv)
                    if iattrs is None \
                            or float(iattrs.get("scalar", 0.0)) != 1.0:
                        continue
                    if _entry_key(inv.inputs[0]) != _entry_key(ohe_e):
                        continue
                    return (tuple(prev_e), tuple(rows_e), tuple(pos_e),
                            tuple(count_e), int(j_pos), depth)
    return None


def _match_kv_write_rows(state, n):
    """Match the FULL masked-blend commit chain rooted at ``n`` — K
    count-masked blends at consecutive positions ``pos..pos+K-1``
    peeling down to the cache input — the long-hand spelling of one
    ``_cache_write_rows(cache, rows, pos, count)`` (the speculative
    multi-token commit).  Requires the j's to descend
    ``K-1..0`` over one shared (rows, pos, count) triple, ``K`` equal
    to the rows operand's axis-1 extent, ``depth`` equal to the cache
    length, and consistent shapes.  Returns ``(cache_entry,
    rows_entry, pos_entry, count_entry)`` or None."""
    top = _match_masked_blend(state, n)
    if top is None:
        return None
    prev_e, rows_e, pos_e, count_e, j, depth = top
    rows_shape = state.shapes.get(_entry_key(rows_e))
    if rows_shape is None or len(rows_shape) < 3 \
            or rows_shape[1] != j + 1:
        return None                     # top blend must be j == K-1
    expect = j - 1
    while expect >= 0:
        m = _match_masked_blend(state, prev_e[0])
        if m is None or prev_e[1] != 0:
            return None
        p2, r2, po2, c2, j2, d2 = m
        if j2 != expect or d2 != depth \
                or _entry_key(r2) != _entry_key(rows_e) \
                or _entry_key(po2) != _entry_key(pos_e) \
                or _entry_key(c2) != _entry_key(count_e):
            return None
        prev_e = p2
        expect -= 1
    cache_e = prev_e
    cshape = state.shapes.get(_entry_key(cache_e))
    pshape = state.shapes.get(_entry_key(pos_e))
    tshape = state.shapes.get(_entry_key(count_e))
    if cshape is None or pshape is None or tshape is None \
            or len(cshape) < 2:
        return None
    if cshape[1] != depth or pshape != (cshape[0],) \
            or tshape != (cshape[0],) \
            or rows_shape != (cshape[0], rows_shape[1]) \
            + tuple(cshape[2:]):
        return None
    return cache_e, rows_e, pos_e, count_e


def _select_pass(state):
    """Swap matched one-hot-blend KV writes for ``_cache_write_row``.

    The replacement must hand consumers exactly the blend's output
    signature (the scatter's output is the cache's shape and dtype, so
    a blend whose arithmetic PROMOTED the dtype — e.g. an f16 cache
    blended through an f32 mask — fails the guard and stands down).
    Semantic boundary, stated for the record: the blend treats an
    out-of-range ``pos`` as a no-op (the one-hot row is all zero)
    while the scatter clamps it into range, and a non-finite value in
    the overwritten cell propagates through the blend's ``c*0`` but
    not through the scatter — both are outside the decode engine's
    cache discipline (positions bounded by ``max_len``, joining slots
    zeroed), which is why selection is opt-in
    (``MXNET_OPT_SELECT_KERNELS``) rather than a default rewrite.
    """
    repl = {}
    applied = 0
    for n in _topo(state.symbol._outputs):
        if n.op is None or (id(n), 0) in repl:
            continue
        mr = _match_kv_write_rows(state, n)
        if mr is not None:
            cache_e, rows_e, pos_e, count_e = mr
            out_s, out_d = state.sig((n, 0))
            c_s, c_d = state.sig(tuple(cache_e))
            if out_s is None or out_d is None \
                    or out_s != c_s or out_d != c_d:
                continue    # promotion/broadcast changed the signature
            opdef = get_op("_cache_write_rows")
            node = SymNode(opdef,
                           _unique_name(state.taken,
                                        n.name + "_scatter_rows"),
                           opdef.normalize({}),
                           [tuple(cache_e), tuple(rows_e),
                            tuple(pos_e), tuple(count_e)])
            state.track(node, shape=out_s, dtype=out_d)
            repl[(id(n), 0)] = (node, 0)
            state.attr.setdefault(id(n), "select")
            state.record(
                "select", "select", n,
                "masked one-hot-blend commit chain -> "
                "_cache_write_rows(%s, %s, %s, %s): one widened "
                "scatter commits the accepted speculative rows in "
                "place of %d chained O(max_len*d) blends"
                % (cache_e[0].name, rows_e[0].name, pos_e[0].name,
                   count_e[0].name,
                   (state.shapes.get(_entry_key(rows_e))
                    or (0, 0))[1]))
            applied += 1
            continue
        m = _match_kv_write(state, n)
        if m is None:
            continue
        cache_e, row_e, pos_e = m
        out_s, out_d = state.sig((n, 0))
        c_s, c_d = state.sig(tuple(cache_e))
        if out_s is None or out_d is None \
                or out_s != c_s or out_d != c_d:
            continue        # promotion/broadcast changed the signature
        opdef = get_op("_cache_write_row")
        node = SymNode(opdef,
                       _unique_name(state.taken, n.name + "_scatter"),
                       opdef.normalize({}),
                       [tuple(cache_e), tuple(row_e), tuple(pos_e)])
        state.track(node, shape=out_s, dtype=out_d)
        repl[(id(n), 0)] = (node, 0)
        state.attr.setdefault(id(n), "select")
        state.record(
            "select", "select", n,
            "one-hot-blend KV write -> _cache_write_row(%s, %s, %s): "
            "O(d) scatter-at-index replaces the O(max_len*d) blend"
            % (cache_e[0].name, row_e[0].name, pos_e[0].name))
        applied += 1
    _apply(state, repl)
    return applied


# ---------------------------------------------------------------------------
# the plan and the pipeline
# ---------------------------------------------------------------------------


OPT_PASSES = {"select": _select_pass}


class OptPlan(object):
    """Outcome of one optimization attempt: ``accepted``, ``reason`` (on
    rejection), ``symbol`` (the optimized clone, None when rejected),
    ``actions``, ``rewrites`` and node counts.  ``gate`` names what
    adopted it (see the module docstring)."""

    def __init__(self):
        self.accepted = False
        self.reason = None
        self.symbol = None
        self.actions = []
        self.passes = ()
        self.nodes_before = None
        self.nodes_after = None
        self.gate = GATE

    def _reject(self, reason):
        self.accepted = False
        self.reason = reason
        self.symbol = None
        return self

    @property
    def rewrites(self):
        """Actions that changed the graph."""
        return list(self.actions)

    def __repr__(self):
        return "<OptPlan %s: %d rewrite(s), %s -> %s nodes>" % (
            "accepted" if self.accepted
            else "rejected: %s" % self.reason,
            len(self.rewrites), self.nodes_before, self.nodes_after)


def optimize_graph(symbol, data_shapes=None, dtypes=None, passes=None,
                   max_iter=8):
    """Run the pass pipeline over a clone of ``symbol`` (never mutated)
    to a fixed point; returns an :class:`OptPlan`.  ``data_shapes`` and
    ``dtypes`` ({input name: shape / dtype}) seed the environment the
    matchers read; a rewrite whose entries it cannot prove stands down."""
    names = tuple(passes if passes is not None else SELECT_OPT_PASSES)
    for p in names:
        if p not in OPT_PASSES:
            raise MXNetError("unknown optimization pass %r (ported: %s)"
                             % (p, sorted(OPT_PASSES)))
    plan = OptPlan()
    plan.passes = names
    plan.nodes_before = len(_topo(symbol._outputs))
    try:
        shapes0, dtypes0 = infer_graph_env(symbol._outputs,
                                           data_shapes or {}, dtypes)
    except MXNetError as e:
        return plan._reject("shape inference failed: %s" % e)
    clone, node_map = copy_graph(symbol)
    remap = lambda env: {(id(node_map[nid]), i): v  # noqa: E731
                         for (nid, i), v in env.items() if nid in node_map}
    state = OptState(clone, remap(shapes0), remap(dtypes0))
    for _ in range(max_iter):
        if not sum(OPT_PASSES[p](state) for p in names):
            break
    plan.actions = list(state.actions)
    plan.nodes_after = len(_topo(clone._outputs))
    plan.symbol = clone
    plan.accepted = True
    if not plan.rewrites:
        return plan
    # acceptance: the outputs keep their count, shapes and dtypes
    try:
        shapes1, dtypes1 = infer_graph_env(clone._outputs,
                                           data_shapes or {}, dtypes)
    except MXNetError as e:
        return plan._reject("optimized graph fails shape inference: %s"
                            % e)
    if len(clone._outputs) != len(symbol._outputs):
        return plan._reject("optimized graph changed the output count")
    for k, ((n0, i0), (n1, i1)) in enumerate(zip(symbol._outputs,
                                                 clone._outputs)):
        before = (shapes0.get((id(n0), i0)), dtypes0.get((id(n0), i0)))
        after = (shapes1.get((id(n1), i1)), dtypes1.get((id(n1), i1)))
        if before != after:
            return plan._reject("output %d signature changed: %s -> %s"
                                % (k, before, after))
    return plan
