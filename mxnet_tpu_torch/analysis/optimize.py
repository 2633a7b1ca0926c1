"""Verdict-gated optimizing pass pipeline over the Symbol IR.

Counterpart of ``mxnet_tpu/analysis/optimize.py``: the same passes, the
same acceptance protocol, and the same actions and optimized JSON for
the same graph.  The analysis suite classifies and repairs (padding.py /
rewrite.py); this module OPTIMIZES, in the TVM/Relay mold: an ordered,
fixed-point pipeline of rewriting passes over one cloned Symbol, each
rewrite expressed through ``symbol.copy_graph`` + ``graph.
redirect_entries``, and — the load-bearing part — a candidate graph is
adopted ONLY if re-running verify+shapes+padding yields verdicts no
worse than the input graph's (:data:`GATE`).  An optimizer bug can
therefore never silently change an output signature or break padding
soundness: the broken candidate is rejected with a reasoned plan and the
caller keeps serving the original graph.

Passes (``DEFAULT_OPT_PASSES`` order; ``register_opt_pass`` adds more):

- ``algebraic`` — identity simplification: ``x+0``, ``x-0``, ``x*1``,
  ``x/1`` (scalar and known-uniform-constant operand forms), ``_copy``,
  cast-to-same-dtype, identity/double transpose and SwapAxis pairs,
  reshape-of-reshape collapse, identity reshape/2-D Flatten.  Every
  bypass is guarded on the shape/dtype environment: the replacement
  entry must carry exactly the bypassed node's output signature.
  (``x*0`` is deliberately NOT folded: ``NaN*0 = NaN``.)
- ``fold``    — constant folding: subgraphs whose leaves are all
  analysis-time constants (deterministic zero-input creation ops) are
  evaluated ONCE through the registry impls and spliced back as a baked
  ``_constant`` node; a fold is kept only when the baked value
  round-trips its serialized form bitwise and stays under
  ``fold_limit`` elements.  The fold runs on ``device``, the device the
  graph will run on: the executor computes a constant subgraph on the
  graph's device too (creation ops' outputs move there first), so the
  baked bits are the bits the unoptimized graph computes — a fold on
  the CPU for a graph served on the card could move a transcendental
  (``exp``) by an ulp.
- ``cse``     — common-subexpression elimination keyed on a canonical
  ``(op, normalized attrs, value-numbered input entries)`` hash, with
  commutative-input normalization for the add/mul families.  ``dot`` /
  ``batch_dot`` get no operand reordering.  Stochastic, aux-mutating,
  and host-sync ops are never merged.
- ``dce``     — dead-node elimination from a liveness walk off the
  output set; every swept node is attributed to the pass whose rewrite
  disconnected it (orphaned operand subtrees land on ``dce`` itself).
- ``fuse``    — elementwise-chain fusion hints: maximal
  single-consumer chains of elementwise ops are TAGGED as actions,
  never rewritten.
- ``select``  — fused-op SELECTION: matches subgraphs that state a
  dedicated kernel's semantics the long way and swaps in the registry
  op that says it directly — the one-hot-blend KV-cache row write
  ``cache*(1-oh[...,None]) + row[:,None,:]*oh[...,None]`` with ``oh =
  one_hot(pos, max_len)``, O(max_len*d) per token, becomes
  ``_cache_write_row(cache, row, pos)`` (K9, O(d)), and the speculative
  commit's chain of K count-masked blends becomes
  ``_cache_write_rows(cache, rows, pos, count)`` (K10).  Not in
  ``DEFAULT_OPT_PASSES``: callers opt in via ``SELECT_OPT_PASSES``
  (DecodeEngine does, behind ``MXNET_OPT_SELECT_KERNELS``), and every
  selection rides the same verdict gate — re-analysis no worse, the
  slot axis still row-local under pad-dirty seeding.

Entry point::

    plan = optimize_graph(sym, data_shapes={"data": (8, 6)})
    if plan.accepted and plan.symbol is not None:
        serve(plan.symbol)      # verdicts provably no worse

Wiring: ``ServingEngine`` optimizes the graph its ``ProgramCache`` runs
(``MXNET_SERVE_OPTIMIZE=0`` opt-out) and ``DecodeEngine`` runs
``SELECT_OPT_PASSES`` over its step, draft and commit graphs.
"""
from __future__ import annotations

import collections

import numpy as _np

from ..base import MXNetError
from ..ops import get_op
from ..symbol.symbol import SymNode, copy_graph, _topo
from .core import analyze, as_dtype, same_dtype
from .graph import redirect_entries
from .rewrite import _unique_name

__all__ = ["OptAction", "OptPlan", "OptState", "optimize_graph",
           "register_opt_pass", "DEFAULT_OPT_PASSES", "SELECT_OPT_PASSES",
           "OPT_PASSES", "GATE"]

#: pipeline order: identities first (exposes constants), folding next
#: (creates constants CSE can merge), CSE, then the liveness sweep;
#: the diagnostic fuse pass runs once after the fixed point converges
DEFAULT_OPT_PASSES = ("algebraic", "fold", "cse", "dce", "fuse")

#: the kernel-selection pipeline: selection first (the blend subgraph
#: must be matched before folding/CSE restructure its neighborhood),
#: then the default pipeline — DCE sweeps the orphaned blend nodes and
#: attributes them to ``select``
SELECT_OPT_PASSES = ("select",) + DEFAULT_OPT_PASSES

#: what adopts a plan (``OptPlan.gate``; the decode engine's ``stats()``
#: repeats it)
GATE = ("verdict gate: re-analysis (verify + shapes + padding) no worse, "
        "output shapes and dtypes unchanged, every padded axis that was "
        "row-local still row-local")

#: passes that only observe (no rewrites): excluded from the fixed point
_DIAGNOSTIC_PASSES = frozenset(["fuse"])

#: default cap on baked-constant elements — a fold past this would bloat
#: the serialized symbol more than it saves compile work
DEFAULT_FOLD_LIMIT = 4096

OPT_PASSES = {}

#: one planned rewrite/sweep/hint: ``kind`` is "rewrite" (algebraic
#: bypass), "fold" (baked constant), "merge" (CSE duplicate), "sweep"
#: (DCE removal), or "fusion-hint" (diagnostic only)
OptAction = collections.namedtuple(
    "OptAction", ["pass_name", "kind", "node", "op", "detail"])


def register_opt_pass(name):
    """Decorator registering an optimization pass ``fn(state) -> int``
    (the number of rewrites it applied this sweep) under ``name``."""
    def deco(fn):
        OPT_PASSES[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# pipeline state
# ---------------------------------------------------------------------------

class OptState(object):
    """Mutable state threaded through the pass pipeline: the working
    clone, the shape/dtype environment (seeded from the pre-optimization
    abstract interpretation, extended for nodes passes create), the
    action log, and the removal-attribution bookkeeping DCE consumes."""

    def __init__(self, symbol, shapes, dtypes, training, fold_limit,
                 has_dynamic, device=None):
        self.symbol = symbol
        self.shapes = shapes        # (id(node), out_idx) -> shape tuple
        self.dtypes = dtypes        # (id(node), out_idx) -> core.as_dtype
        self.training = training
        self.fold_limit = fold_limit
        self.device = device        # where ``fold`` evaluates constants
        # data_shapes carried dynamic dims: the env holds representative
        # concretizations, so shape-baking rewrites must stand down
        self.has_dynamic = has_dynamic
        self.actions = []
        self.attr = {}              # id(node) -> pass that disconnected it
        self.known = {}             # id(node) -> (name, op name): DCE universe
        self.removed = collections.Counter()    # pass -> nodes swept
        self.fusion_chains = 0
        self.taken = set()
        for n in _topo(symbol._outputs):
            self.known[id(n)] = (n.name, n.op.name if n.op else None)
            self.taken.add(n.name)

    def track(self, node, shape=None, dtype=None):
        """Register a pass-created node with the DCE universe and the
        shape/dtype environment."""
        self.known[id(node)] = (node.name,
                                node.op.name if node.op else None)
        self.taken.add(node.name)
        if shape is not None:
            self.shapes[(id(node), 0)] = tuple(shape)
        if dtype is not None:
            self.dtypes[(id(node), 0)] = as_dtype(dtype)
        return node

    def record(self, pass_name, kind, node, detail):
        self.actions.append(OptAction(
            pass_name, kind, node.name,
            node.op.name if node.op else None, detail))

    def sig(self, entry):
        key = (id(entry[0]), entry[1])
        return self.shapes.get(key), self.dtypes.get(key)


def _resolve(repl, entry):
    """Follow a replacement chain to its terminal entry (a sweep may
    bypass ``a -> b`` and ``b -> c`` in the same pass)."""
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
# algebraic / identity simplification
# ---------------------------------------------------------------------------

def _uniform_value(node):
    """The one scalar a creation node provably holds in EVERY element,
    else None — the operand test for ``x+0`` / ``x*1`` style rules."""
    if node.op is None:
        return None
    attrs = _norm(node)
    if attrs is None:
        return None
    name = node.op.name
    if name == "_zeros":
        return 0.0
    if name == "_ones":
        return 1.0
    if name == "_full":
        return float(attrs["value"])
    if name == "_constant":
        vals = attrs.get("value") or ()
        if vals and all(v == vals[0] for v in vals):
            return float(vals[0])
    return None


def _perm(attrs_axes, rank):
    axes = tuple(attrs_axes or ())
    if not axes:
        return tuple(reversed(range(rank)))
    return tuple(ax % rank for ax in axes)


def _identity_target(state, n):
    """An existing entry computing exactly what ``n`` computes, or
    None.  Callers still guard the output signature."""
    attrs = _norm(n)
    if attrs is None:
        return None
    name = n.op.name
    if name == "_copy":
        return n.inputs[0]
    # signed zero: IEEE -0.0 + (+0.0) is +0.0, so the bypass keeps a
    # -0.0 that the unoptimized eager add turns into +0.0 — the two
    # compare equal, and every other value is bitwise the same.  The
    # JAX package takes the same rule (XLA folds x+0 -> x in its
    # unoptimized program too), and the rules stay the same here
    if name in ("_plus_scalar", "_minus_scalar") \
            and attrs.get("scalar") == 0.0:
        return n.inputs[0]
    if name in ("_mul_scalar", "_div_scalar", "_power_scalar") \
            and attrs.get("scalar") == 1.0:
        return n.inputs[0]
    if name in ("_add", "_mul") and len(n.inputs) == 2:
        ident = 0.0 if name == "_add" else 1.0
        for side in (0, 1):
            if _uniform_value(n.inputs[1 - side][0]) == ident:
                return n.inputs[side]
    if name in ("_sub", "_div") and len(n.inputs) == 2:
        ident = 0.0 if name == "_sub" else 1.0
        if _uniform_value(n.inputs[1][0]) == ident:
            return n.inputs[0]
    if name == "Cast":
        in_dt = state.dtypes.get((id(n.inputs[0][0]), n.inputs[0][1]))
        if in_dt is not None and same_dtype(attrs["dtype"], in_dt):
            return n.inputs[0]
    if name == "transpose":
        in_shape = state.shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
        if in_shape is None:
            return None
        rank = len(in_shape)
        p_out = _perm(attrs.get("axes"), rank)
        if p_out == tuple(range(rank)):
            return n.inputs[0]
        prod = n.inputs[0][0]
        if prod.op is not None and prod.op.name == "transpose":
            pattrs = _norm(prod)
            pin = state.shapes.get((id(prod.inputs[0][0]),
                                    prod.inputs[0][1]))
            if pattrs is not None and pin is not None \
                    and len(pin) == rank:
                p_in = _perm(pattrs.get("axes"), rank)
                if tuple(p_in[p_out[i]] for i in range(rank)) \
                        == tuple(range(rank)):
                    return prod.inputs[0]
    if name == "SwapAxis":
        if attrs["dim1"] == attrs["dim2"]:
            return n.inputs[0]
        prod = n.inputs[0][0]
        if prod.op is not None and prod.op.name == "SwapAxis":
            pattrs = _norm(prod)
            if pattrs is not None and \
                    {pattrs["dim1"], pattrs["dim2"]} == \
                    {attrs["dim1"], attrs["dim2"]}:
                return prod.inputs[0]
    if name == "Flatten":
        in_shape = state.shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
        if in_shape is not None and len(in_shape) == 2:
            return n.inputs[0]      # rank-2 flatten is the identity
    if name == "Reshape" and not state.has_dynamic:
        spec = attrs.get("shape") or ()
        in_shape = state.shapes.get((id(n.inputs[0][0]), n.inputs[0][1]))
        if _clean_reshape_spec(spec) and -1 not in spec \
                and in_shape is not None and tuple(spec) == in_shape \
                and not attrs.get("reverse") \
                and not attrs.get("target_shape"):
            return n.inputs[0]
    return None


def _clean_reshape_spec(spec):
    """A reshape spec with no input-relative magic codes (0/-2/-3/-4)
    and at most one -1: it resolves identically against any
    equal-element-count input, so reshape chains may collapse."""
    return bool(spec) and all(d >= 1 or d == -1 for d in spec) \
        and list(spec).count(-1) <= 1


def _reshape_merge(state, n):
    """Reshape-of-reshape: a clean-spec Reshape reading a chain of
    Reshape/Flatten producers reads the chain's source directly — the
    intermediate layouts are unobservable (row-major element order is
    preserved through every hop and the element count is invariant)."""
    if n.op.name != "Reshape":
        return None
    attrs = _norm(n)
    if attrs is None or attrs.get("reverse") or attrs.get("target_shape"):
        return None
    if not _clean_reshape_spec(attrs.get("shape") or ()):
        return None
    src = n.inputs[0]
    hops = 0
    while True:
        prod = src[0]
        if prod.op is not None and prod.op.name in ("Reshape", "Flatten"):
            src = prod.inputs[0]
            hops += 1
        else:
            break
    if hops == 0:
        return None
    new = SymNode(n.op, _unique_name(state.taken, n.name + "_merged"),
                  dict(n.attrs), [tuple(src)])
    out_s, out_d = state.sig((n, 0))
    state.track(new, shape=out_s, dtype=out_d)
    return (new, 0)


@register_opt_pass("algebraic")
def _algebraic_pass(state):
    repl = {}
    applied = 0
    for n in _topo(state.symbol._outputs):
        if n.op is None or (id(n), 0) in repl:
            continue
        try:
            if n.num_outputs() != 1:
                continue
        except Exception:
            continue
        tgt = _identity_target(state, n)
        if tgt is not None:
            # the bypass must hand consumers EXACTLY the bypassed
            # node's output signature (a broadcasting x+0 whose zero
            # widened the result must keep the add)
            out_s, out_d = state.sig((n, 0))
            tgt_s, tgt_d = state.sig(tuple(tgt))
            if out_s is None or out_d is None \
                    or out_s != tgt_s or out_d != tgt_d:
                continue
            repl[(id(n), 0)] = tuple(tgt)
            state.attr.setdefault(id(n), "algebraic")
            state.record("algebraic", "rewrite", n,
                         "identity: consumers read %r directly"
                         % tgt[0].name)
            applied += 1
            continue
        merged = _reshape_merge(state, n)
        if merged is not None:
            repl[(id(n), 0)] = merged
            state.attr.setdefault(id(n), "algebraic")
            state.record("algebraic", "rewrite", n,
                         "reshape chain collapsed onto %r"
                         % merged[0].inputs[0][0].name)
            applied += 1
    _apply(state, repl)
    return applied


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------

#: dtypes whose values round-trip exactly through the _constant op's
#: float-tuple serialization (checked bitwise per fold anyway; this set
#: short-circuits dtypes that can never pass, e.g. bfloat16, which the
#: _constant op cannot rebuild)
_FOLDABLE_DTYPES = frozenset([
    "bool", "int8", "uint8", "int16", "int32", "int64",
    "float16", "float32", "float64",
])


def _const_nodes(topo):
    """Ids of nodes computable at analysis time: deterministic op nodes
    whose transitive leaves are all zero-input creation ops."""
    const = set()
    for n in topo:
        if n.op is None:
            continue
        op = n.op
        if op.stochastic or op.host_sync or op.mutate_aux \
                or op.mode_dependent:
            continue
        if all(id(i) in const for (i, _ix) in n.inputs):
            const.add(id(n))
    return const


def _eval_const(state, node, cache):
    """Evaluate one constant node (and its constant ancestors) through
    the registry impls on ``state.device``, as the executor computes
    them there; memoized in ``cache`` keyed by entry.  Returns the
    node's output-0 tensor, or None when evaluation fails or an
    intermediate exceeds the fold limit."""
    import torch
    device = state.device
    stack = [node]
    with torch.inference_mode():
        while stack:
            n = stack[-1]
            if (id(n), 0) in cache:
                stack.pop()
                continue
            pending = [i for (i, ix) in n.inputs
                       if (id(i), ix) not in cache]
            if pending:
                stack.extend(pending)
                continue
            attrs = _norm(n)
            if attrs is None:
                return None
            try:
                ins = [cache[(id(i), ix)] for (i, ix) in n.inputs]
                outs = n.op.bound(attrs, state.training)(*ins)
                if not n.inputs:
                    # a creation op makes its value on the host; the
                    # executor moves it to the graph's device
                    outs = tuple(o.to(device) for o in outs)
            except Exception:
                return None
            for i, o in enumerate(outs):
                if o.numel() > state.fold_limit:
                    return None
                cache[(id(n), i)] = o
            stack.pop()
    return cache.get((id(node), 0))


def _bake_constant(state, n, val):
    """Materialize ``val`` (a tensor) as a ``_constant`` node, or None
    when the value cannot round-trip its serialized float-tuple form
    bitwise (the fold would not be value-preserving)."""
    dtype = as_dtype(val.dtype)
    if isinstance(dtype, str) or dtype.name not in _FOLDABLE_DTYPES \
            or val.numel() > state.fold_limit:
        return None
    try:
        val = val.detach().cpu().numpy()
        flat = tuple(float(x)
                     for x in _np.asarray(val, dtype=_np.float64).ravel())
        # mirror the _constant impl's reconstruction exactly
        rebuilt = _np.asarray(
            _np.array(flat, dtype=_np.float64).reshape(val.shape),
            dtype=dtype)
    except Exception:
        return None
    if rebuilt.tobytes() != _np.ascontiguousarray(val).tobytes():
        return None
    opdef = get_op("_constant")
    attrs = opdef.normalize({"value": flat, "shape": tuple(val.shape),
                             "dtype": dtype.name})
    # the port's creation ops also take a ``ctx``; a baked constant
    # leaves it unset (the executor moves it to the graph's device), so
    # the node and its JSON are the JAX package's
    if attrs.get("ctx") is None:
        attrs.pop("ctx", None)
    node = SymNode(opdef, _unique_name(state.taken, n.name + "_folded"),
                   attrs, [])
    state.track(node, shape=val.shape, dtype=dtype)
    return node


@register_opt_pass("fold")
def _fold_pass(state):
    topo = _topo(state.symbol._outputs)
    const = _const_nodes(topo)
    if not const:
        return 0
    # frontier: a constant node whose value escapes into non-constant
    # consumers (or the output set) — fold there, once, so one baked
    # constant replaces the whole upstream subtree
    escapes = set()
    for n in topo:
        if id(n) in const:
            continue
        for (i, _ix) in n.inputs:
            if id(i) in const:
                escapes.add(id(i))
    for (h, _ix) in state.symbol._outputs:
        if id(h) in const:
            escapes.add(id(h))
    by_id = {id(n): n for n in topo}
    repl = {}
    cache = {}
    applied = 0
    for nid in sorted(escapes, key=lambda x: by_id[x].name):
        n = by_id[nid]
        if not n.inputs:
            continue        # already a leaf creation op: nothing to bake
        try:
            if n.num_outputs() != 1:
                continue
        except Exception:
            continue
        val = _eval_const(state, n, cache)
        if val is None:
            continue
        cnode = _bake_constant(state, n, val)
        if cnode is None:
            continue
        repl[(id(n), 0)] = (cnode, 0)
        state.attr.setdefault(id(n), "fold")
        state.record("fold", "fold", n,
                     "baked %s%s constant (evaluated at analysis time)"
                     % (as_dtype(val.dtype).name, tuple(val.shape)))
        applied += 1
    _apply(state, repl)
    return applied


# ---------------------------------------------------------------------------
# common-subexpression elimination
# ---------------------------------------------------------------------------

#: ops whose two operands commute, so CSE sorts them into a canonical
#: order before hashing.  dot/batch_dot are intentionally ABSENT:
#: matrix products do not commute, so only argument-identical
#: contractions merge (via the plain structural hash).
_COMMUTATIVE = frozenset([
    "_add", "_mul", "_maximum", "_minimum", "_hypot",
    "equal", "not_equal", "logical_and", "logical_or", "logical_xor",
])


def _freeze_attrs(attrs):
    def fz(v):
        if isinstance(v, (list, tuple)):
            return tuple(fz(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((k, fz(x)) for k, x in v.items()))
        return v
    return tuple(sorted((k, fz(v)) for k, v in attrs.items()
                        if not k.startswith("_")))


@register_opt_pass("cse")
def _cse_pass(state):
    topo = _topo(state.symbol._outputs)
    order = {id(n): i for i, n in enumerate(topo)}
    canon = {}      # entry key -> leader entry (value numbering)
    table = {}      # canonical hash -> leader node
    repl = {}
    applied = 0

    def centry(e):
        return canon.get((id(e[0]), e[1]), tuple(e))

    for n in topo:
        if n.op is None:
            continue
        op = n.op
        if op.stochastic or op.host_sync or op.mutate_aux:
            continue        # merging would change draw/state semantics
        attrs = _norm(n)
        if attrs is None:
            continue
        try:
            nout = n.num_outputs()
        except Exception:
            continue
        ins = [centry(e) for e in n.inputs]
        if op.name in _COMMUTATIVE and len(ins) == 2:
            ins.sort(key=lambda e: (order.get(id(e[0]), 1 << 30),
                                    e[1], e[0].name))
        key = (op.name, _freeze_attrs(attrs),
               tuple((id(e[0]), e[1]) for e in ins), nout)
        leader = table.get(key)
        if leader is None:
            table[key] = n
            continue
        for i in range(nout):
            canon[(id(n), i)] = (leader, i)
            repl[(id(n), i)] = (leader, i)
        state.attr.setdefault(id(n), "cse")
        state.record("cse", "merge", n,
                     "duplicate of %r (canonical hash match)"
                     % leader.name)
        applied += 1
    _apply(state, repl)
    return applied


# ---------------------------------------------------------------------------
# dead-node elimination
# ---------------------------------------------------------------------------

@register_opt_pass("dce")
def _dce_pass(state):
    """Liveness walk off the output set: everything in the known-node
    universe no longer reachable is swept.  Nodes a rewrite directly
    bypassed are attributed to that pass; orphaned operand subtrees
    (the classic dead branch) are DCE's own harvest.  Returns 0 —
    sweeping cannot enable further rewrites, so it never extends the
    fixed point."""
    live = {id(n) for n in _topo(state.symbol._outputs)}
    for nid in [k for k in state.known if k not in live]:
        name, opname = state.known.pop(nid)
        cause = state.attr.pop(nid, None)
        # purge the dead node's id-keyed signature entries: once swept
        # it can be garbage-collected and CPython may recycle the id
        # for a node a later pass creates — a stale entry would hand
        # that new node a wrong shape/dtype and mislead the identity
        # guards
        for env in (state.shapes, state.dtypes):
            for key in [k for k in env if k[0] == nid]:
                del env[key]
        state.removed[cause or "dce"] += 1
        if cause is None:
            state.actions.append(OptAction(
                "dce", "sweep", name, opname,
                "unreachable from the output set"))
    return 0


# ---------------------------------------------------------------------------
# elementwise-chain fusion hints (diagnostic only)
# ---------------------------------------------------------------------------

_FUSIBLE_CACHE = []


def _fusible_ops():
    """Primary names of the elementwise ops a fuser merges into
    producer-consumer chains — derived from the op tables so it cannot
    drift."""
    if _FUSIBLE_CACHE:
        return _FUSIBLE_CACHE[0]
    from ..ops import elemwise as _ew
    names = set()
    for cand in list(_ew._UNARY) + list(_ew._SCALAR):
        try:
            names.add(get_op(cand).name)
        except MXNetError:
            pass
    for cand in list(_ew._BINARY) + list(_ew._BINARY_LOGIC):
        try:
            names.add(get_op("broadcast_" + cand).name)
        except MXNetError:
            pass
    for cand in ("Activation", "LeakyReLU", "Cast", "clip", "_copy",
                 "add_n", "smooth_l1"):
        try:
            names.add(get_op(cand).name)
        except MXNetError:
            pass
    fus = frozenset(names)
    _FUSIBLE_CACHE.append(fus)
    return fus


@register_opt_pass("fuse")
def _fuse_pass(state):
    fus = _fusible_ops()
    topo = _topo(state.symbol._outputs)
    ncons = collections.Counter()
    sole = {}
    for n in topo:
        for (i, _ix) in n.inputs:
            ncons[id(i)] += 1
            sole[id(i)] = n if ncons[id(i)] == 1 else None
    for (h, _ix) in state.symbol._outputs:
        ncons[id(h)] += 1
        sole[id(h)] = None
    in_chain = set()
    for n in topo:
        if id(n) in in_chain or n.op is None or n.op.name not in fus:
            continue
        prod = n.inputs[0][0] if n.inputs else None
        if prod is not None and prod.op is not None \
                and prod.op.name in fus and ncons[id(prod)] == 1:
            continue    # an upstream fusible producer starts this chain
        chain = [n]
        cur = n
        while ncons[id(cur)] == 1:
            c = sole.get(id(cur))
            if c is None or c.op is None or c.op.name not in fus:
                break
            chain.append(c)
            cur = c
        if len(chain) < 2:
            continue
        in_chain.update(id(m) for m in chain)
        state.fusion_chains += 1
        state.actions.append(OptAction(
            "fuse", "fusion-hint", chain[0].name, chain[0].op.name,
            "fusible elementwise chain of %d ops: %s"
            % (len(chain), " -> ".join(m.name for m in chain))))
    return 0


# ---------------------------------------------------------------------------
# fused-op selection (opt-in: SELECT_OPT_PASSES / MXNET_OPT_SELECT_KERNELS)
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


@register_opt_pass("select")
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
    zeroed), which is why selection is opt-in and verdict-gated rather
    than a default rewrite.
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
# plan + pipeline
# ---------------------------------------------------------------------------

class OptPlan(object):
    """Outcome of one optimization attempt.

    ``accepted`` is True only when the rewritten clone re-verified with
    an unchanged output signature and padded-axis verdicts no worse
    than the input graph's — or when no pass found anything to rewrite
    (the clone is then the byte-identical graph).  ``symbol`` is the
    optimized graph (None when rejected); the caller must keep serving
    the ORIGINAL graph on rejection.  ``gate`` names the acceptance
    protocol (:data:`GATE`)."""

    def __init__(self):
        self.accepted = False
        self.reason = None
        self.symbol = None
        self.actions = []
        self.passes = ()
        self.per_pass = collections.OrderedDict()
        self.nodes_before = None
        self.nodes_after = None
        self.verdicts_before = {}
        self.verdicts_after = {}
        self.report_before = None
        self.report_after = None
        self.flops_before = None
        self.flops_after = None
        self.gate = GATE

    # ------------------------------------------------------------------
    def _reject(self, reason):
        self.accepted = False
        self.reason = reason
        self.symbol = None
        return self

    @property
    def rewrites(self):
        """Actions that changed the graph (hints and sweeps excluded)."""
        return [a for a in self.actions
                if a.kind not in ("fusion-hint", "sweep")]

    @property
    def fusion_hints(self):
        return [a for a in self.actions if a.kind == "fusion-hint"]

    def flops_delta(self):
        """(fwd_before, fwd_after, delta fraction) or None when the
        FLOPs pass did not run on both sides."""
        if not self.flops_before or not self.flops_after:
            return None
        b, a = self.flops_before["fwd"], self.flops_after["fwd"]
        return (b, a, (a - b) / b if b else 0.0)

    def describe(self):
        """Human-readable report (the CLI / engine log surface)."""
        if self.accepted and not self.rewrites:
            head = "graph optimization: nothing to rewrite " \
                   "(%d node(s))" % (self.nodes_before or 0)
        elif self.accepted:
            head = "graph optimization: ACCEPTED (%d -> %d node(s); " \
                   "re-analysis verdicts no worse)" \
                   % (self.nodes_before, self.nodes_after)
        else:
            head = "graph optimization: REJECTED (%s) — serving the " \
                   "unoptimized graph" % (self.reason or "unknown")
        lines = [head]
        for p, st in self.per_pass.items():
            if p in _DIAGNOSTIC_PASSES:
                if st["applied"]:
                    lines.append("  - %s: %d fusible elementwise "
                                 "chain(s) tagged" % (p, st["applied"]))
                continue
            if st["applied"] or st["nodes_removed"]:
                lines.append("  - %s: %d rewrite(s), %d node(s) removed"
                             % (p, st["applied"], st["nodes_removed"]))
        delta = self.flops_delta()
        if delta is not None and self.rewrites:
            lines.append("  analytic fwd FLOPs: %.4g -> %.4g (%+.1f%%)"
                         % (delta[0], delta[1], 100.0 * delta[2]))
        shown = self.actions[:20]
        for a in shown:
            lines.append("    [%s] %s %s (%s): %s"
                         % (a.pass_name, a.kind, a.node, a.op, a.detail))
        if len(self.actions) > len(shown):
            lines.append("    ... +%d more action(s)"
                         % (len(self.actions) - len(shown)))
        return "\n".join(lines)

    def to_dict(self):
        """Machine-readable section for ``graph_lint --json``."""
        delta = self.flops_delta()
        # on rejection every planned rewrite was thrown away: the
        # per-pass "rejected" column mirrors the engine's
        # mxnet_serve_opt_rejected_total{pass} attribution — only
        # graph-changing actions count (fusion hints and DCE sweeps
        # are not rewrites that could have been rejected)
        rej = collections.Counter(a.pass_name for a in self.rewrites)
        per_pass = {}
        for p, st in self.per_pass.items():
            row = dict(st)
            row["rejected"] = 0 if self.accepted else int(rej.get(p, 0))
            if not self.accepted:
                row["applied"] = 0
            per_pass[p] = row
        return {
            "accepted": self.accepted,
            "reason": self.reason,
            "nodes_before": self.nodes_before,
            "nodes_after": self.nodes_after,
            "per_pass": per_pass,
            "actions": [{"pass": a.pass_name, "kind": a.kind,
                         "node": a.node, "op": a.op, "detail": a.detail}
                        for a in self.actions],
            "verdicts_before": dict(self.verdicts_before),
            "verdicts_after": dict(self.verdicts_after),
            "flops": None if delta is None else {
                "fwd_before": delta[0], "fwd_after": delta[1],
                "delta_pct": 100.0 * delta[2]},
            "fusion_hints": [a.detail for a in self.fusion_hints],
        }

    def __repr__(self):
        return "<OptPlan %s: %d rewrite(s), %s -> %s nodes>" % (
            "accepted" if self.accepted
            else "rejected: %s" % self.reason,
            len(self.rewrites), self.nodes_before, self.nodes_after)


def _device(device):
    """The torch device ``fold`` evaluates on: ``device`` (a Context, a
    torch device or its name), else the current context's."""
    import torch
    from ..context import default_context
    if device is None:
        device = default_context()
    return torch.device(getattr(device, "device", device))


def optimize_graph(symbol, data_shapes=None, dtypes=None, policy=None,
                   pad_axes=None, training=False, valid_lengths=None,
                   passes=None, max_iter=8,
                   fold_limit=DEFAULT_FOLD_LIMIT, precomputed=None,
                   pad_dirty=None, device=None):
    """Run the optimizing pass pipeline over ``symbol``; returns an
    :class:`OptPlan`.

    The input graph is never mutated: passes rewrite a
    ``symbol.copy_graph`` clone.  ``data_shapes``/``dtypes`` seed the
    shape/dtype environment the identity guards and constant folder
    read (rewrites needing an entry the environment cannot prove simply
    stand down).  ``pad_axes``/``policy``/``valid_lengths`` forward to
    the padding classifier exactly as in :func:`~.core.analyze`; when a
    padded-axis spec is present the acceptance bar includes "no padded
    axis verdict gets worse".  ``precomputed`` may carry a
    ``(report, ctx)`` pair from an ``analyze`` run over the SAME
    symbol/shapes/spec so the pre-optimization analysis is not
    repeated.  ``pad_dirty`` forwards to the padding classifier on
    BOTH sides of the acceptance re-analysis (decode slot-state
    inputs: stale garbage gets no zero-absorption credit — the
    ``check_decode_step`` seeding, so a kernel selection over a decode
    step is gated on the same row-locality bar the engine's preflight
    enforces).  ``device`` is where the graph will run (a Context, a
    torch device or its name; None = the current context, the first
    card unless a ``with cpu():`` scope is open, raising when there is
    none): ``fold`` evaluates constants there.
    Never raises for an unoptimizable graph: the plan carries
    ``accepted=False`` and the reason.
    """
    device = _device(device)
    names = tuple(passes if passes is not None else DEFAULT_OPT_PASSES)
    for p in names:
        if p not in OPT_PASSES:
            raise MXNetError("unknown optimization pass %r (known: %s)"
                             % (p, sorted(OPT_PASSES)))
    plan = OptPlan()
    plan.passes = names
    # padding always runs: with no explicit spec the classifier falls
    # back to its default batch-axis reading, so even a plain
    # optimize_graph() call gets the verdict-no-worse acceptance gate
    analysis_passes = ["verify", "shapes", "padding", "flops"]
    if precomputed is not None:
        report0, ctx0 = precomputed
        if getattr(ctx0, "flops", None) is None:
            # the engine's check_serving_graph ctx carries shapes but
            # never ran the flops pass — run it in place (it only
            # reads ctx.shapes) so the plan's FLOP delta is populated
            # on the reuse path too
            from .flops import FlopsPass
            try:
                FlopsPass().run(ctx0, report0)
            except Exception:
                pass        # delta stays None; never block the plan
    else:
        report0, ctx0 = analyze(symbol, data_shapes=data_shapes,
                                dtypes=dtypes, policy=policy,
                                pad_axes=pad_axes, training=training,
                                valid_lengths=valid_lengths,
                                pad_dirty=pad_dirty,
                                passes=tuple(analysis_passes))
    plan.report_before = report0
    plan.verdicts_before = dict(ctx0.pad_verdicts)
    plan.flops_before = getattr(ctx0, "flops", None)
    topo0 = _topo(symbol._outputs)
    plan.nodes_before = len(topo0)
    if report0.errors:
        return plan._reject(
            "graph does not verify (%d error(s)) — optimization only "
            "runs on verified graphs" % len(report0.errors))

    clone, node_map = copy_graph(symbol)
    shapes_env, dtypes_env = {}, {}
    for (nid, i), s in ctx0.shapes.items():
        c = node_map.get(nid)
        if c is not None:
            shapes_env[(id(c), i)] = tuple(s)
    for (nid, i), d in ctx0.node_dtypes.items():
        c = node_map.get(nid)
        if c is not None:
            dtypes_env[(id(c), i)] = as_dtype(d)
    # the interpreter seeds dtype entries only for variables with an
    # explicit dtype; every other variable it CONSUMED as float32
    # (shapes.py's in_dtypes default), so the downstream entries above
    # were derived under that belief — mirror it here or every bypass
    # whose replacement target is a raw input stands down on a missing
    # dtype
    f32 = _np.dtype(_np.float32)
    for n in _topo(clone._outputs):
        if n.op is None and (id(n), 0) not in dtypes_env:
            dtypes_env[(id(n), 0)] = f32
    has_dynamic = any(
        s and any(d in (0, None) for d in s)
        for s in (data_shapes or {}).values() if s is not None)
    state = OptState(clone, shapes_env, dtypes_env, training,
                     fold_limit, has_dynamic, device=device)

    rewriting = [p for p in names if p not in _DIAGNOSTIC_PASSES]
    for _ in range(max_iter):
        changed = 0
        for p in rewriting:
            changed += OPT_PASSES[p](state)
        if not changed:
            break
    if "dce" in rewriting:
        OPT_PASSES["dce"](state)        # final sweep (idempotent)
    for p in names:
        if p in _DIAGNOSTIC_PASSES:
            OPT_PASSES[p](state)

    plan.actions = list(state.actions)
    plan.nodes_after = len(_topo(clone._outputs))
    for p in names:
        plan.per_pass[p] = {
            "applied": sum(1 for a in plan.actions
                           if a.pass_name == p and a.kind != "sweep"),
            "nodes_removed": int(state.removed.get(p, 0)),
        }
    # DCE's own sweeps (orphaned operands) count as its applications
    if "dce" in plan.per_pass:
        plan.per_pass["dce"]["applied"] = sum(
            1 for a in plan.actions
            if a.pass_name == "dce" and a.kind == "sweep")

    if not plan.rewrites:
        # byte-identical graph: nothing to re-verify
        plan.accepted = True
        plan.symbol = clone
        plan.verdicts_after = dict(plan.verdicts_before)
        plan.report_after = report0
        plan.flops_after = plan.flops_before
        return plan

    # -- acceptance: re-analysis verdicts must be no worse --------------
    data_shapes2 = {k: v for k, v in (data_shapes or {}).items()}
    report1, ctx1 = analyze(clone, data_shapes=data_shapes2,
                            dtypes=dtypes, policy=policy,
                            pad_axes=pad_axes, training=training,
                            valid_lengths=valid_lengths,
                            pad_dirty=pad_dirty,
                            passes=tuple(analysis_passes))
    plan.report_after = report1
    plan.verdicts_after = dict(ctx1.pad_verdicts)
    plan.flops_after = getattr(ctx1, "flops", None)
    if report1.errors:
        return plan._reject("optimized graph fails re-verification:\n%s"
                            % report1.format())
    if len(clone._outputs) != len(symbol._outputs):
        return plan._reject("optimized graph changed the output count "
                            "(%d -> %d) — please report"
                            % (len(symbol._outputs), len(clone._outputs)))
    for k, ((n0, i0), (n1, i1)) in enumerate(zip(symbol._outputs,
                                                 clone._outputs)):
        s0 = ctx0.shapes.get((id(n0), i0))
        s1 = ctx1.shapes.get((id(n1), i1))
        if s0 is not None and tuple(s0) != (
                tuple(s1) if s1 is not None else None):
            return plan._reject(
                "output %d shape changed: %s -> %s — optimization must "
                "preserve the output signature" % (k, s0, s1))
        d0 = ctx0.node_dtypes.get((id(n0), i0))
        d1 = ctx1.node_dtypes.get((id(n1), i1))
        if d1 is None and n1.op is None:
            # a rewrite may legally route an output straight to an
            # input variable; the interpreter leaves un-dtyped
            # variables out of node_dtypes but CONSUMES them as
            # float32, so compare against that same default
            d1 = _np.dtype(_np.float32)
        if d0 is not None and (d1 is None or not same_dtype(d0, d1)):
            return plan._reject(
                "output %d dtype changed: %s -> %s — optimization must "
                "preserve the output signature" % (k, d0, d1))
    for label, before in plan.verdicts_before.items():
        after = plan.verdicts_after.get(label)
        if before == "row-local" and after != "row-local":
            return plan._reject(
                "optimization would make the %r padded-axis verdict "
                "worse (%s -> %s)" % (label, before, after))
    plan.accepted = True
    plan.reason = None
    plan.symbol = clone
    return plan
