"""Speculative draft-k-verify decoding: the engine-side bundle.

Counterpart of ``mxnet_tpu/serving/spec.py``.  Per scheduler iteration a
cheap DRAFT model proposes ``k`` continuation tokens, the TARGET model
scores all ``k+1`` positions, and a slot commits the accepted prefix of
proposals plus one token of the target's.  Under the greedy sampler a
proposal is accepted when it equals the target's own argmax, so the
emitted stream is the exact ``greedy_decode`` stream whatever the draft
proposes (the draft moves throughput, never content).  Under a
stochastic sampler the draft samples its proposals and
:func:`rejection_accept` accepts each with probability ``min(1, p/q)``,
so the emitted stream is distributed as the single-token sampler's.

Per-slot KV caches commit ONLY the accepted tokens.  This module builds
the symbolic COMMIT graph — per declared cache state, a chain of K
count-masked one-hot blends writing rows ``pos..pos+count-1`` — which
the optimizer's ``select`` pass swaps for the ``_cache_write_rows``
kernel (K10).  States are declared cache-like with ``{"name": ...,
"shape": (T, d), "cache": True}`` in ``state_info``; undeclared states
commit by selecting the chain state at the accepted count.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import default_context

__all__ = ["SpecConfig", "build_commit_sym", "select_commit",
           "greedy_accept", "rejection_accept", "commit_select",
           "gather_rows"]


def _draft_key(name):
    """Engine-side key of a draft state buffer in the merged per-slot
    state dict (draft and target state names may collide)."""
    return "draft:" + name


def build_commit_sym(cache_specs, K):
    """The symbolic multi-token commit graph over the declared cache
    states: for each ``(key, buffer_shape, dtype)`` in ``cache_specs``, a
    chain of ``K`` count-masked one-hot blends writing ``rows[:, j]`` at
    position ``pos + j`` when ``count > j``.  Inputs are
    ``__spec_cache__<key>`` / ``__spec_rows__<key>`` per state plus the
    shared ``__spec_pos__`` / ``__spec_count__`` vectors.  Returns
    ``(symbol, shapes, cache_names, rows_names)``, ``shapes`` mapping
    every input to its full slot-pool shape."""
    from .. import symbol as sym
    from ..base import NameManager
    with NameManager():
        # a fresh name counter: the graph's auto-named nodes come out the
        # same however many graphs this process built before
        return _build_commit_sym(sym, cache_specs, K)


def _build_commit_sym(sym, cache_specs, K):
    pos = sym.Variable("__spec_pos__")
    count = sym.Variable("__spec_count__")
    n_slots = cache_specs[0][1][0]
    shapes = {"__spec_pos__": (n_slots,), "__spec_count__": (n_slots,)}
    outs, cache_names, rows_names = [], [], []
    for key, shape, _dt in cache_specs:
        if len(shape) != 3:
            raise MXNetError(
                "spec commit: cache state %r has buffer shape %s; the "
                "one-hot-blend commit form (and the _cache_write_rows "
                "selection) support (slots, max_len, d) caches only"
                % (key, (shape,)))
        T = int(shape[1])
        cname = "__spec_cache__%s" % key
        rname = "__spec_rows__%s" % key
        cache = sym.Variable(cname)
        rows = sym.Variable(rname)
        shapes[cname] = tuple(shape)
        shapes[rname] = (shape[0], K) + tuple(shape[2:])
        cache_names.append(cname)
        rows_names.append(rname)
        c = cache
        for j in range(K):
            posj = pos + float(j)
            mje = sym.expand_dims(count > float(j), axis=1)
            ohm = sym.broadcast_mul(sym.one_hot(posj, depth=T), mje)
            ohe = sym.expand_dims(ohm, axis=2)
            rowj = sym.slice_axis(rows, axis=1, begin=j, end=j + 1)
            c = sym.broadcast_mul(c, 1.0 - ohe) \
                + sym.broadcast_mul(rowj, ohe)
        outs.append(c)
    return sym.Group(outs), shapes, cache_names, rows_names


def select_commit(commit, shapes, cache_names, rows_names, device=None):
    """Run the verdict-gated ``_cache_write_rows`` selection over a built
    commit graph at its input ``shapes``: slot axis 0 padded everywhere,
    caches AND rows pad-dirty.  Returns ``(served_sym, selection,
    plan)``: the optimized graph and its selections when the plan
    accepted with rewrites, else the input graph (selection ``[]``).
    ``device`` is where the commit runs (constants fold there; None =
    the current context, as in :func:`~..analysis.optimize_graph`)."""
    from ..analysis import optimize_graph, SELECT_OPT_PASSES
    plan = optimize_graph(
        commit, data_shapes=shapes,
        pad_axes={"slot": {n: 0 for n in shapes}},
        pad_dirty=tuple(cache_names) + tuple(rows_names),
        passes=SELECT_OPT_PASSES, device=device)
    if plan.accepted and plan.symbol is not None and plan.rewrites:
        sel = [{"op": "_cache_write_rows", "site": a.node}
               for a in plan.actions if a.kind == "select"]
        return plan.symbol, sel, plan
    return commit, [], plan


class SpecConfig(object):
    """Everything the wider step program needs about the draft half: the
    draft graph (outputs ``[logits] + next_draft_states``), its params and
    per-slot state info, and — after :meth:`build` — the commit graph."""

    def __init__(self, k, draft_sym, draft_arg_params=None,
                 draft_aux_params=None, draft_state_info=None,
                 token_name="token", pos_name="pos",
                 valid_name="valid"):
        self.k = int(k)
        if self.k < 1:
            raise MXNetError("speculative decode needs k >= 1 draft "
                             "tokens per step (k=0 is the plain "
                             "single-token engine — leave spec off)")
        self.K = self.k + 1
        self.draft_sym = draft_sym
        self.draft_arg_params = draft_arg_params or {}
        self.draft_aux_params = draft_aux_params or {}
        self.draft_state_info = [dict(s)
                                 for s in (draft_state_info or [])]
        self.token_name = token_name
        self.pos_name = pos_name
        self.valid_name = valid_name
        # filled by build()
        self.commit_sym = None
        self.commit_shapes = None
        self.commit_plan = None
        self.selection = []
        self._built = False

    def draft_state_names(self):
        return [s["name"] for s in self.draft_state_info]

    def draft_keys(self):
        return [_draft_key(s["name"]) for s in self.draft_state_info]

    def cache_infos(self, state_info):
        """(key, info) pairs of the CACHE-declared states across both
        models: target states under their own names, draft states under
        their prefixed engine keys."""
        out = [(s["name"], s) for s in state_info if s.get("cache")]
        out += [(_draft_key(s["name"]), s)
                for s in self.draft_state_info if s.get("cache")]
        return out

    def build(self, num_slots, state_info, dtype, device=None):
        """Build the commit graph and run the selection over it, once
        (``device``: where the commit runs; None = the current
        context)."""
        if self._built:
            return self
        if device is None:
            device = default_context().device
        specs = []
        for key, info in self.cache_infos(state_info):
            dt = np.dtype(info.get("dtype") or dtype)
            shape = (int(num_slots),) + tuple(info["shape"])
            specs.append((key, shape, dt))
        if not specs:
            self._built = True
            return self
        commit, shapes, cache_names, rows_names = build_commit_sym(
            specs, self.K)
        served = commit
        from .. import config
        if config.get("MXNET_SERVE_OPTIMIZE") \
                and config.get("MXNET_OPT_SELECT_KERNELS") \
                and config.get("MXNET_ANALYSIS_ON"):
            try:
                served, self.selection, self.commit_plan = \
                    select_commit(commit, shapes, cache_names, rows_names,
                                  device=device)
            except Exception as e:    # optimizer crash must never block
                warnings.warn("speculative commit optimization crashed "
                              "(%r); serving the blend-chain commit"
                              % (e,))
            if self.commit_plan is not None \
                    and not self.commit_plan.accepted:
                warnings.warn("speculative commit optimization rejected "
                              "(%s); serving the blend-chain commit"
                              % self.commit_plan.reason)
        self.commit_sym = served
        self.commit_shapes = shapes
        self._built = True
        return self



# ---------------------------------------------------------------------------
# accept and commit, on the device
# ---------------------------------------------------------------------------

def greedy_accept(xs, tlogits):
    """Exact-prefix greedy acceptance: ``xs`` is the draft's input chain
    (``xs[0]`` the staged token, ``xs[1..k]`` the proposals), ``tlogits``
    the K per-position target logits.  Returns ``(toks, a)``: the (N, K)
    matrix of the target's own argmax at every position (first index on
    ties, as the argmax op) and the (N,) count of leading proposals that
    matched it, both in the logits' dtype."""
    g = [torch.argmax(L, dim=1).to(L.dtype) for L in tlogits]
    toks = torch.stack(g, dim=1)
    K = len(tlogits)
    if K > 1:
        matches = torch.stack(
            [(xs[j + 1] == g[j]).to(torch.float32) for j in range(K - 1)],
            dim=1)
        a = torch.cumprod(matches, dim=1).sum(dim=1)
    else:
        a = torch.zeros((toks.shape[0],), dtype=torch.float32,
                        device=toks.device)
    return toks, a


def rejection_accept(xs, tlogits, dlogits, transform, uniforms, gumbels):
    """Standard speculative rejection sampling (Leviathan/Chen), with its
    noise given: proposal ``x_j ~ q_j`` is accepted with probability
    ``min(1, p_j(x_j) / q_j(x_j))`` (``uniforms[j] <`` that), the first
    rejection at position j emits a draw from ``norm(max(p_j - q_j,
    0))`` instead, and k accepts earn one bonus draw from ``p_k``; the
    position-i draw is Gumbel-max with ``gumbels[i]``.  ``transform``
    maps raw logits to the sampler's log-space distribution (temperature,
    top-k mask), applied alike to both models.  ``xs`` is the draft's
    input chain (``xs[0]`` the staged token, ``xs[1..k]`` the
    proposals).  Returns ``(toks, a)``: the (N, K) emitted tokens and the
    (N,) accepted count, in the logits' dtype and float32."""
    from .decode import categorical
    K = len(tlogits)
    N = tlogits[0].shape[0]
    dt = tlogits[0].dtype
    zt = [transform(L) for L in tlogits]
    p = torch.stack([torch.softmax(z, dim=-1) for z in zt], dim=1)
    q = None
    if K > 1:
        zq = [transform(d) for d in dlogits[:K - 1]]
        q = torch.stack([torch.softmax(z, dim=-1) for z in zq], dim=1)
        xi = torch.stack([x.long() for x in xs[1:K]], dim=1)[..., None]
        px = torch.gather(p[:, :K - 1], 2, xi)[..., 0]
        qx = torch.gather(q, 2, xi)[..., 0]
        ratio = torch.where(qx > 0, px / torch.where(qx > 0, qx,
                                                     torch.ones_like(qx)),
                            torch.zeros_like(qx))
        us = torch.stack(list(uniforms), dim=1)
        accept = (us < torch.clamp(ratio, max=1.0)).to(torch.float32)
        a = torch.cumprod(accept, dim=1).sum(dim=1)
    else:
        a = torch.zeros((N,), dtype=torch.float32, device=p.device)
    cols = []
    for i in range(K):
        if i < K - 1:
            # the residual at the first rejection: the part of p the
            # draft under-covered; an all-zero residual (p == q) falls
            # back to p, as in the JAX package
            r = torch.clamp(p[:, i] - q[:, i], min=0.0)
            rs = r.sum(dim=-1, keepdim=True)
            logr = torch.where(r > 0, torch.log(torch.where(
                r > 0, r, torch.ones_like(r))),
                torch.full_like(r, -float("inf")))
            logits_i = torch.where(rs > 0, logr, zt[i])
        else:
            logits_i = zt[i]
        fresh = categorical(logits_i, gumbels[i]).to(dt)
        acc_tok = xs[i + 1].to(dt) if i < K - 1 else fresh
        cols.append(torch.where(a > i, acc_tok, fresh))
    return torch.stack(cols, dim=1), a


def commit_select(chain, idx):
    """Commit one NON-cache state by selecting the chain candidate at the
    accepted count: ``chain`` holds the K per-step values (state after
    consuming 1..K tokens), ``idx`` the (N,) int ``count - 1``."""
    stacked = torch.stack(chain, dim=1)
    ix = idx.long().reshape((-1, 1) + (1,) * (stacked.dim() - 2))
    ix = ix.expand((-1, 1) + tuple(stacked.shape[2:]))
    return torch.gather(stacked, 1, ix)[:, 0]


def gather_row(state, pos, j, T):
    """The row that step ``j`` of a chain wrote into one CACHE state:
    row ``pos + j``, clamped like the write itself, as (N, 1) + tail."""
    ix = (pos.to(torch.int32) + j).clamp(0, T - 1).long()
    return state[torch.arange(state.shape[0], device=state.device),
                 ix].unsqueeze(1)


def gather_rows(chain, pos, T):
    """Collect the per-step written rows of one CACHE state: step j of
    ``chain`` wrote row ``pos + j``.  Returns the (N, K) + tail rows
    tensor the commit graph consumes."""
    return torch.cat([gather_row(s, pos, j, T) for j, s in enumerate(chain)],
                     dim=1)
