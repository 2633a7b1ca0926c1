"""Continuous batching for autoregressive decode: iteration-level
scheduling over a persistent slot pool.

Counterpart of ``mxnet_tpu/serving/decode.py`` on one device.  A static
batch holds every finished sequence until the slowest member completes;
this engine schedules at the *iteration* level instead:

- **one persistent step program** over a fixed slot pool
  (``MXNET_DECODE_SLOTS`` slots x ``MXNET_DECODE_MAX_LEN`` positions):
  requests join and leave the running batch BETWEEN steps, and no shape
  ever changes, so nothing is rebuilt under churn;
- **device-resident per-slot state**: a ``(slots, max_len, d)`` KV cache
  per state, written at one position per step, never grown.  The host
  ships only the per-step token, position and occupancy vectors and
  receives only the sampled token ids back.  The step donates the state
  buffers to the graph (as the reference donates them to its compiled
  step), so the cache writes K9/K10 update them in place;
- **joining slots** are zeroed row by row, in place, just before the
  step that first reads them (the reference zeroes whole buffers with a
  ``where`` inside its compiled step, free there and an
  O(slots*max_len*d) pass per state here);
- **masked dead slots** ride along holding whatever a finished request
  left; every op along the slot axis reads only its own row, so a
  request's tokens do not depend on its company;
- **bucketed prefill**: a prompt is consumed either token by token
  through the running step batch (teacher forcing, no extra programs),
  or, with a ``prefill_sym``, in ONE dispatch through a
  :class:`~.buckets.ProgramCache` at pow2 prompt buckets, its output
  state rows written into the slot.  Concurrent joiners coalesce
  (``MXNET_DECODE_COALESCE_PREFILL``, on by default): requests joining in
  the same scheduler iteration whose prompts pad to the same bucket
  share one dispatch at the next pow2 batch extent;
- **samplers**: the default greedy head is an ``argmax`` spliced into
  the step graph; :class:`TemperatureSampler` (temperature, top-k,
  Gumbel-max) samples on the device after the step graph from noise
  drawn from a ``torch.Generator`` on the engine's device, seeded by
  ``seed`` and the step's tick, so a seeded engine replays bit for bit
  and only token ids cross to the host;
- **soundness preflight** (``MXNET_ANALYSIS_ON``): the step graph (and
  the draft's) must be row-local along the SLOT axis with the state
  seeded pad-dirty (``analysis.check_decode_step``) — a cross-position
  step would let one request's (or a dead slot's stale) values bleed
  into a co-resident request's tokens.  It warns, or raises under
  ``MXNET_ANALYSIS_STRICT=1``; ``step_verdict``, ``draft_verdict`` and
  ``analysis_report`` keep the result;
- **fused-op selection** (``MXNET_SERVE_OPTIMIZE`` +
  ``MXNET_OPT_SELECT_KERNELS``, both on by default): before any program
  is built, ``analysis.SELECT_OPT_PASSES`` runs over the step graph
  (and the draft's): the ``select`` pass swaps the one-hot-blend cache
  writes for ``_cache_write_row`` (K9) and the speculative commit's
  blend chains for ``_cache_write_rows`` (K10), then the default passes
  fold, merge and sweep.  A plan is adopted only through the verdict
  gate (re-analysis no worse, the slot axis still row-local under
  pad-dirty seeding); ``stats()`` names the gate;
- **speculative draft-k-verify** (``spec_k``): see ``serving/spec.py``;
  greedy acceptance is exact prefix match, a stochastic sampler's is
  rejection sampling (``spec.rejection_accept``).  The draft and target
  chains run on working copies of the caches (one copy per cache per
  speculative step), so the commit writes only the accepted rows into
  the ORIGINAL buffers, which keep every other row bit for bit;
- **memory preflight** (``MXNET_MEMORY_PLAN``): the step (and draft)
  programs at slot-pool shapes with the pool's state-for-state donation
  gated for soundness, plus the largest prefill bucket over the resident
  pool, priced against the device budget before any program runs;
- **per-token streaming** (``on_token``), **admission** (bounded queue,
  ``reject`` or ``shed-oldest``) and **per-step deadlines**: an expired
  request, queued or mid-generation, completes with its PARTIAL
  output.

One scheduler thread does all of the engine's device work, warmup
included (cuBLAS handles are per thread; a warmup on another thread
would leave the first live steps to build them again).

Telemetry (``MXNET_TELEMETRY_ON``): the reference's ``mxnet_serve_*``
and ``mxnet_serve_decode_*`` families (``_DecodeTelemetry``), a
tail-biased ``decode.request`` trace per request (queue-wait and decode
spans), TTFT and TPOT histograms, the efficiency plane's FLOPs ledger
(the step program priced once; live, dead-slot and rejected-draft
shares), the fleet timeline, the scheduler's heartbeat with the default
alert rules, and the HTTP endpoint.  Off, the engine holds no instrument
and decodes the same tokens.

Not ported: replicas and the router, sharding plans, the AOT cache, the
SSE token streams (``submit(request_id=)``), fault injection, the
supervisor and ``rehabilitate``, and the overload regulator.

Step-graph contract: ``step_sym`` outputs ``[logits] + next_states`` over
arguments ``token`` (slot vector of last token ids), the state names from
``state_info`` (each ``(slots,) + per_slot_shape``), and optionally
``pos`` (per-slot write position) and ``valid`` (1/0 occupancy).  Under
the greedy sampler the engine appends an ``argmax`` head so only token
ids cross to the host.
"""
from __future__ import annotations

import collections
import threading
import time
import warnings
import weakref
from concurrent.futures import Future, TimeoutError as FutureTimeout

import numpy as np
import torch

from .. import symbol as sym
from .. import telemetry as _telemetry
from ..base import MXNetError
from ..context import default_context
from ..executor import _count_xla_trace, build_graph_fn
from ..ops.registry import torch_dtype
from ..telemetry import goodput as _goodput
from .admission import (AdmissionController, Request, EngineClosedError,
                        _fail_future)
from .buckets import ProgramCache, _next_pow2
from .engine import (_ENGINE_SEQ, _REPLICA, _memory_stats_block,
                     memory_metric_families, refresh_memory_gauges)
from . import spec as _spec_mod

__all__ = ["DecodeEngine", "DecodeResult", "StepProgram", "greedy_decode",
           "Sampler", "GreedySampler", "TemperatureSampler", "gumbel",
           "categorical"]


def gumbel(u):
    """Standard Gumbel noise from uniforms in [0, 1), as the JAX
    package's ``jax.random.gumbel`` makes it: the uniform clamped below
    at float32's smallest normal (so no draw is infinite), then
    ``-log(-log(u))``."""
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(z, g):
    """One Gumbel-max draw per row: ``argmax(z + g)`` over the last axis
    (the first index on ties), as ``jax.random.categorical`` draws from
    log-space ``z`` with its own Gumbel noise ``g``."""
    return torch.argmax(z + g.to(z.dtype), dim=-1)


class Sampler(object):
    """Token-selection head of the decode step.

    The step graph's contract is ``[logits] + next_states``; a sampler
    turns each slot's logits row into its token id.  ``greedy=True``
    keeps the in-graph ``argmax`` head (bitwise ``greedy_decode``).  A
    stochastic sampler runs on the device after the step graph, on noise
    the step program draws from its generator (a pure function of the
    sampler's ``seed`` and the step's tick), so a seeded engine replays
    bit for bit against the same submission history; its draws also
    depend on which ticks and slots a request rode through."""
    greedy = False

    def sample(self, logits, noise):
        """``(slots, vocab)`` logits and Gumbel noise of the same shape ->
        ``(slots,)`` sampled ids in the logits' dtype."""
        raise NotImplementedError

    def spec_logits(self, logits):
        """Raw logits -> the sampler's log-space distribution
        (temperature, top-k mask): what speculative rejection sampling
        verifies draft proposals against, applied alike to target and
        draft logits.  Greedy samplers never call it."""
        raise MXNetError(
            "%s does not support speculative decode: implement "
            "spec_logits() (the distribution rejection sampling "
            "verifies against)" % type(self).__name__)

    def describe(self):
        return {"kind": type(self).__name__}


class GreedySampler(Sampler):
    """The default argmax head, spliced into the step GRAPH itself, so
    greedy decode is bitwise ``greedy_decode``."""
    greedy = True

    def describe(self):
        return {"kind": "greedy"}


class TemperatureSampler(Sampler):
    """Temperature (optionally top-k-truncated) categorical sampling:
    ``logits / temperature``, then every logit below the k-th largest
    pinned to ``-inf`` (ties with the k-th are kept), then one
    Gumbel-max draw per slot.  ``top_k=1`` is argmax whatever the noise.
    ``seed`` fixes the noise stream for replays; None draws it from the
    port's random stream (``mxnet_tpu_torch.random``)."""

    def __init__(self, temperature=1.0, top_k=None, seed=None):
        if temperature <= 0:
            raise MXNetError("TemperatureSampler: temperature must be "
                             "> 0, got %r (top_k=1 IS argmax)"
                             % (temperature,))
        if top_k is not None and int(top_k) < 1:
            raise MXNetError("TemperatureSampler: top_k must be >= 1")
        self.temperature = float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.seed = seed

    def sample(self, logits, noise):
        return categorical(self.spec_logits(logits), noise).to(logits.dtype)

    def spec_logits(self, logits):
        z = logits / self.temperature
        if self.top_k is not None and self.top_k < z.shape[-1]:
            kth = torch.topk(z, self.top_k, dim=-1).values[..., -1:]
            z = torch.where(z < kth, torch.full_like(z, -float("inf")), z)
        return z

    def describe(self):
        return {"kind": "temperature", "temperature": self.temperature,
                "top_k": self.top_k, "seed": self.seed}


def _mix_seed(seed, tick):
    """A 63-bit generator seed from (seed, tick): splitmix64's finalizer
    over their combination, so neighbouring ticks seed unrelated
    streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(tick) + 1) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


class DecodeResult(object):
    """What a decode future resolves to: the generated token ids plus how
    generation ended.  ``finish_reason`` is ``"eos"``, ``"length"``
    (max_new_tokens or the slot's max_len), ``"deadline"`` (tokens holds
    the PARTIAL generation; ``expired`` is True) or ``"closed"`` (engine
    shut down without drain)."""
    __slots__ = ("tokens", "finish_reason", "n_steps", "prompt_len")

    def __init__(self, tokens, finish_reason, n_steps=0, prompt_len=0):
        self.tokens = np.asarray(tokens, dtype=np.int64)
        self.finish_reason = finish_reason
        self.n_steps = n_steps
        self.prompt_len = prompt_len

    @property
    def expired(self):
        return self.finish_reason == "deadline"

    def __len__(self):
        return len(self.tokens)

    def __repr__(self):
        return ("<DecodeResult %d tokens, %s>"
                % (len(self.tokens), self.finish_reason))


class DecodeRequest(Request):
    """One decode request: a prompt plus the generation bookkeeping the
    scheduler mutates as the request moves queue -> slot -> done.
    ``on_token`` is called with each generated id, in order, from the
    scheduler thread; a raising callback evicts only its own request."""
    __slots__ = ("prompt", "max_new", "tokens", "prompt_i", "slot",
                 "t_join", "n_steps", "on_token", "t_first_tok",
                 "t_last_tok", "uflops")

    def __init__(self, prompt, max_new, future, deadline=None,
                 trace=None, on_token=None):
        super().__init__({}, ("__decode__",), future, deadline=deadline,
                         trace=trace)
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.on_token = on_token
        self.tokens = []            # generated ids (host mirror)
        self.prompt_i = 0           # next prompt token to teacher-force
        self.slot = None
        self.t_join = None
        self.n_steps = 0
        self.t_first_tok = None     # monotonic stamps: TTFT / TPOT
        self.t_last_tok = None
        self.uflops = 0             # useful FLOPs owed to the tenant


class StepProgram(object):
    """The persistent decode step over a fixed slot pool.

    Wraps ``step_sym`` (outputs ``[logits] + next_states``) with a greedy
    ``argmax`` head, with a stochastic sampler's draw after the graph, or,
    with a :class:`~.spec.SpecConfig`, with the speculative
    draft-k-verify unroll.  Parameters are placed on the
    device once; per-slot state lives there between calls as the tensors
    :meth:`init_states` made.  A step DONATES the state tensors it is
    given: it may write them in place, and the caller reads the returned
    dict, never the old one.  ``build_count`` counts the graph functions
    built (step, draft, commit), all in the constructor."""

    def __init__(self, step_sym, arg_params, aux_params, state_info,
                 num_slots, token_name="token", pos_name="pos",
                 valid_name="valid", ctx=None, dtype=np.float32,
                 sampler=None, spec=None):
        self._ctx = default_context(ctx)
        self._device = self._ctx.device
        self._spec = spec
        self.num_slots = int(num_slots)
        self._dtype = np.dtype(dtype)
        self.sampler = sampler if sampler is not None else GreedySampler()
        self.state_info = [dict(s) for s in state_info]
        self.state_names = [s["name"] for s in self.state_info]
        self.token_name = token_name
        if len(step_sym) != 1 + len(self.state_names):
            raise MXNetError(
                "decode step graph has %d outputs; expected 1 (logits) "
                "+ %d next-state outputs (state_info order)"
                % (len(step_sym), len(self.state_names)))
        # the spec program needs per-position raw logits (its accept
        # logic samples them), and so does a stochastic sampler; the
        # greedy step keeps the in-graph head
        head = step_sym[0] if spec is not None or not self.sampler.greedy \
            else sym.argmax(step_sym[0], axis=1, name="__decode_sample__")
        self._serve_sym = sym.Group(
            [head] + [step_sym[i] for i in range(1, len(step_sym))])
        arg_names = self._serve_sym.list_arguments()
        aux_names = self._serve_sym.list_auxiliary_states()
        if token_name not in arg_names:
            raise MXNetError("decode step graph has no %r input "
                             "(token_name); arguments: %s"
                             % (token_name, arg_names))
        missing = [n for n in self.state_names if n not in arg_names]
        if missing:
            raise MXNetError("decode step graph is missing state "
                             "input(s) %s" % missing)
        self.pos_name = pos_name if pos_name in arg_names else None
        self.valid_name = valid_name if valid_name in arg_names else None
        feeds = set([token_name] + self.state_names)
        feeds.update(n for n in (self.pos_name, self.valid_name) if n)
        self._na = len(arg_names)
        self._template, self._feed_pos = self._place(
            list(arg_names) + list(aux_names), feeds, arg_params or {},
            aux_params or {}, "StepProgram")
        self._gf = build_graph_fn(self._serve_sym, arg_names, aux_names)
        self.build_count = 1
        _count_xla_trace()
        self._cache_t = []          # (name, T) target cache states
        self._cache_d = []          # (key, T) draft cache states
        self.draft_state_keys = []
        if spec is not None:
            self._init_spec(spec, pos_name)
        # a stochastic sampler's noise: step t draws from a generator
        # seeded by (seed, t), so draws are a pure function of the seed
        # and the tick, whatever ran before on the device
        self._tick = 0
        seed = getattr(self.sampler, "seed", None)
        if seed is None:
            from .. import random as _random
            seed = int(torch.randint(1 << 62, (1,),
                                     generator=_random.generator()))
        self._seed = int(seed)
        self._gen = None

    def _place(self, order, feeds, arg_params, aux_params, what):
        """(flat template with every parameter on the device, {feed name:
        position in the flat vector})."""
        lacking = [n for n in order
                   if n not in feeds and n not in arg_params
                   and n not in aux_params]
        if lacking:
            raise MXNetError("%s: params missing for %s" % (what, lacking))
        template = [None] * len(order)
        for i, n in enumerate(order):
            if n not in feeds:
                src = arg_params if n in arg_params else aux_params
                template[i] = src[n].as_in_context(self._ctx)._data
        return template, {n: order.index(n) for n in feeds}

    def _init_spec(self, dspec, pos_name):
        dspec.build(self.num_slots, self.state_info, self._dtype,
                    device=self._ctx.device)
        dsym = sym.Group(list(dspec.draft_sym))
        d_args = dsym.list_arguments()
        d_auxs = dsym.list_auxiliary_states()
        if dspec.token_name not in d_args:
            raise MXNetError("draft graph has no %r input; arguments: %s"
                             % (dspec.token_name, d_args))
        d_states = dspec.draft_state_names()
        missing = [n for n in d_states if n not in d_args]
        if missing:
            raise MXNetError("draft graph is missing state input(s) %s"
                             % missing)
        if len(dsym) != 1 + len(d_states):
            raise MXNetError("draft graph has %d outputs; expected 1 "
                             "(logits) + %d next-state outputs"
                             % (len(dsym), len(d_states)))
        self._d_tok = dspec.token_name
        self._d_pos = dspec.pos_name if dspec.pos_name in d_args else None
        self._d_valid = (dspec.valid_name if dspec.valid_name in d_args
                         else None)
        d_feeds = set([self._d_tok] + d_states)
        d_feeds.update(n for n in (self._d_pos, self._d_valid) if n)
        self._d_na = len(d_args)
        self._d_template, self._d_feed_pos = self._place(
            list(d_args) + list(d_auxs), d_feeds, dspec.draft_arg_params,
            dspec.draft_aux_params, "SpecConfig (draft)")
        self._d_states = d_states
        self.draft_state_keys = dspec.draft_keys()
        self._gf_d = build_graph_fn(dsym, d_args, d_auxs)
        self.build_count += 1
        _count_xla_trace()
        for info in self.state_info:
            if info.get("cache"):
                if self.pos_name is None:
                    raise MXNetError(
                        "state %r is cache-declared but the step graph has "
                        "no %r input — a positional cache commit needs the "
                        "write position" % (info["name"], pos_name))
                self._cache_t.append((info["name"], int(info["shape"][0])))
        for info in dspec.draft_state_info:
            if info.get("cache"):
                if self._d_pos is None:
                    raise MXNetError("draft state %r is cache-declared but "
                                     "the draft graph has no %r input"
                                     % (info["name"], dspec.pos_name))
                self._cache_d.append((_spec_mod._draft_key(info["name"]),
                                      int(info["shape"][0])))
        self._gf_commit = self._commit_args = None
        if dspec.commit_sym is not None:
            self._commit_args = dspec.commit_sym.list_arguments()
            self._gf_commit = build_graph_fn(dspec.commit_sym,
                                             self._commit_args, [])
            self.build_count += 1
            _count_xla_trace()

    # ------------------------------------------------------------- state
    def _state_infos(self, which="all"):
        """(engine state key, info) pairs over the requested model half:
        ``"all"``, ``"target"`` or ``"draft"``."""
        if which in ("all", "target"):
            for info in self.state_info:
                yield info["name"], info
        if self._spec is not None and which in ("all", "draft"):
            for info in self._spec.draft_state_info:
                yield _spec_mod._draft_key(info["name"]), info

    def init_states(self):
        """Fresh all-zero slot-pool state buffers on this program's
        device."""
        out = {}
        for key, info in self._state_infos():
            dt = torch_dtype(np.dtype(info.get("dtype") or self._dtype))
            out[key] = torch.zeros((self.num_slots,) + tuple(info["shape"]),
                                   dtype=dt, device=self._device)
        return out

    def write_row(self, states, slot, rows):
        """Write per-slot state rows (host or device arrays) into ``slot``
        of every buffer named in ``rows``, in place; returns the state
        dict."""
        out = dict(states)
        with torch.no_grad():
            for name, row in rows.items():
                out[name][slot] = torch.as_tensor(
                    np.asarray(row) if not isinstance(row, torch.Tensor)
                    else row).to(out[name].dtype)
        return out

    def zero_row(self, states, slot, which="all"):
        """Zero one slot's rows in every state buffer of ``which``."""
        rows = {}
        for key, info in self._state_infos(which):
            dt = np.dtype(info.get("dtype") or self._dtype)
            rows[key] = np.zeros(tuple(info["shape"]), dtype=dt)
        return self.write_row(states, slot, rows)

    def _zero_joining(self, states, reset):
        """Zero, in place, the rows of the slots ``reset`` marks (1/0 host
        vector) in every state buffer: a joining request never inherits
        the previous occupant's state."""
        if reset is None:
            return
        idx = np.flatnonzero(np.asarray(reset) > 0)
        if not len(idx):
            return
        it = torch.as_tensor(idx, device=self._device)
        for key, _info in self._state_infos():
            states[key].index_fill_(0, it, 0)

    def _vec(self, v):
        return torch.tensor(np.asarray(v, np.float32), device=self._device)

    # ------------------------------------------------------------ noise
    def _next_tick(self):
        self._tick = (self._tick + 1) & 0x7fffffff
        return self._tick

    def noise(self, tick):
        """The generator of one step's draws, seeded by (seed, tick)."""
        if self._gen is None:
            self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(_mix_seed(self._seed, tick))
        return self._gen

    def _uniform(self, gen, shape):
        return torch.rand(shape, generator=gen, device=self._device,
                          dtype=torch.float32)

    def _gumbel(self, gen, shape):
        return gumbel(self._uniform(gen, shape))

    def sample_tokens(self, logits):
        """Sample a ``(rows, vocab)`` logits tensor with this program's
        sampler on its device: the bucketed prefill's first token (its
        program returns raw logits for stochastic samplers).  Each call
        takes a tick, so prefill draws never repeat a step's.  Returns
        host float32 ids."""
        if self.sampler.greedy:
            return torch.argmax(logits, dim=-1).cpu().numpy().astype(
                np.float32)
        gen = self.noise(self._next_tick())
        out = self.sampler.sample(logits, self._gumbel(gen, logits.shape))
        return out.float().cpu().numpy()

    # -------------------------------------------------------------- step
    def _run_target(self, tok, pos, valid, cur, donated):
        flat = list(self._template)
        flat[self._feed_pos[self.token_name]] = tok
        if self.pos_name is not None:
            flat[self._feed_pos[self.pos_name]] = pos
        if self.valid_name is not None:
            flat[self._feed_pos[self.valid_name]] = valid
        for name in self.state_names:
            flat[self._feed_pos[name]] = cur[name]
        outs, _ = self._gf(flat[:self._na], flat[self._na:],
                           donated=donated)
        return outs[0], {n: outs[1 + i]
                         for i, n in enumerate(self.state_names)}

    def _run_draft(self, tok, pos, valid, cur, donated):
        flat = list(self._d_template)
        flat[self._d_feed_pos[self._d_tok]] = tok
        if self._d_pos is not None:
            flat[self._d_feed_pos[self._d_pos]] = pos
        if self._d_valid is not None:
            flat[self._d_feed_pos[self._d_valid]] = valid
        for name, key in zip(self._d_states, self.draft_state_keys):
            flat[self._d_feed_pos[name]] = cur[key]
        outs, _ = self._gf_d(flat[:self._d_na], flat[self._d_na:],
                             donated=donated)
        return outs[0], {k: outs[1 + i]
                         for i, k in enumerate(self.draft_state_keys)}

    def step(self, tokens, pos, valid, states, reset=None):
        """One decode iteration over the whole pool.  ``tokens``/``pos``/
        ``valid`` are host float32 vectors of length ``num_slots``;
        ``states`` the buffers from :meth:`init_states` or the previous
        step (donated).  ``reset`` marks slots (1/0) whose state rows must
        read as zeros this step.  Returns (sampled ids as a host float
        vector, new state dict)."""
        if self._spec is not None:
            raise MXNetError("this StepProgram runs a speculative "
                             "draft-k-verify step: dispatch through "
                             "step_spec()")
        with torch.no_grad():
            self._zero_joining(states, reset)
            sampled, new_states = self._run_target(
                self._vec(tokens), self._vec(pos), self._vec(valid), states,
                donated=self.state_names)
            tick = self._next_tick()
            if not self.sampler.greedy:
                sampled = self.sampler.sample(
                    sampled, self._gumbel(self.noise(tick), sampled.shape))
            return sampled.cpu().numpy(), new_states

    def step_spec(self, tokens, pos, valid, spec, states, reset=None):
        """One speculative iteration over the whole pool: up to ``k + 1``
        tokens commit per slot.  ``spec`` marks the slots eligible for
        speculation (generating, past their prompt); the others commit
        exactly one position.  Returns ``(tokens, counts, new_states)``:
        a ``(slots, k+1)`` host token matrix, the per-slot committed
        counts, and the committed state dict.

        Under a stochastic sampler the draft PROPOSES by sampling its
        distribution and the accept is rejection sampling; the step's
        noise is drawn in the JAX package's fold-in order: proposal j's
        Gumbels, then uniform j, for each j, then the fallback Gumbels of
        every position.

        The chains run on working copies of the caches (the executor
        copies an undonated buffer before a cache write), so the commit
        writes the accepted rows into the original buffers and leaves
        every other row as it was."""
        if self._spec is None:
            raise MXNetError("step_spec() needs a StepProgram built with "
                             "a SpecConfig")
        K = self._spec.K
        cache_t = [n for n, _ in self._cache_t]
        cache_d = [n for n, k in zip(self._d_states, self.draft_state_keys)
                   if k in dict(self._cache_d)]
        sampler = self.sampler
        with torch.no_grad():
            self._zero_joining(states, reset)
            tok0, pos0 = self._vec(tokens), self._vec(pos)
            valid_t, spec_m = self._vec(valid), self._vec(spec)
            gen = self.noise(self._next_tick())
            # draft chain: k proposals plus one state-advancing step
            xs, d_chain, dlogits, us = [tok0], [], [], []
            d_rows = {k: [] for k, _ in self._cache_d}
            cur = {k: states[k] for k in self.draft_state_keys}
            for j in range(K):
                logits, cur = self._run_draft(
                    xs[j], pos0 + float(j), valid_t, cur,
                    donated=cache_d if j else ())
                dlogits.append(logits)
                d_chain.append(cur)
                for key, T in self._cache_d:
                    d_rows[key].append(
                        _spec_mod.gather_row(cur[key], pos0, j, T))
                if j < K - 1:
                    if sampler.greedy:
                        xs.append(torch.argmax(logits, dim=1)
                                  .to(logits.dtype))
                    else:
                        g = self._gumbel(gen, logits.shape)
                        xs.append(categorical(sampler.spec_logits(logits), g)
                                  .to(logits.dtype))
                        us.append(self._uniform(gen, (logits.shape[0],)))
            # target chain: score all K positions
            t_chain, tlogits = [], []
            t_rows = {n: [] for n, _ in self._cache_t}
            cur = {n: states[n] for n in self.state_names}
            for j in range(K):
                logits, cur = self._run_target(
                    xs[j], pos0 + float(j), valid_t, cur,
                    donated=cache_t if j else ())
                tlogits.append(logits)
                t_chain.append(cur)
                for name, T in self._cache_t:
                    t_rows[name].append(
                        _spec_mod.gather_row(cur[name], pos0, j, T))
            if sampler.greedy:
                toks, a = _spec_mod.greedy_accept(xs, tlogits)
            else:
                fallback = [self._gumbel(gen, L.shape) for L in tlogits]
                toks, a = _spec_mod.rejection_accept(
                    xs, tlogits, dlogits, sampler.spec_logits, us, fallback)
            count = torch.where(spec_m > 0, a + 1.0,
                                torch.ones_like(a))
            idx = (count - 1.0).to(torch.int32)
            committed = {}
            caches = set(dict(self._cache_t)) | set(dict(self._cache_d))
            for name in self.state_names:
                if name not in caches:
                    committed[name] = _spec_mod.commit_select(
                        [st[name] for st in t_chain], idx)
            for key in self.draft_state_keys:
                if key not in caches:
                    committed[key] = _spec_mod.commit_select(
                        [st[key] for st in d_chain], idx)
            if self._gf_commit is not None:
                cvals = {"__spec_pos__": pos0, "__spec_count__": count}
                rows = dict(t_rows, **d_rows)
                for key, _T in self._cache_t + self._cache_d:
                    cvals["__spec_cache__%s" % key] = states[key]
                    cvals["__spec_rows__%s" % key] = torch.cat(rows[key],
                                                               dim=1)
                outs_c, _ = self._gf_commit(
                    [cvals[n] for n in self._commit_args], [],
                    donated=["__spec_cache__%s" % key for key, _T
                             in self._cache_t + self._cache_d])
                for i, (key, _T) in enumerate(self._cache_t
                                              + self._cache_d):
                    committed[key] = outs_c[i]
            host = torch.cat([toks, count.to(toks.dtype)[:, None]],
                             dim=1).cpu().numpy()
        keys = list(self.state_names) + list(self.draft_state_keys)
        return host[:, :K], host[:, K], {k: committed[k] for k in keys}

    def probe_step(self):
        """One dispatch over an all-zero scratch pool with all-zero
        feeds at tick 0; touches no live state and leaves the tick where
        it was.  Two programs built from the same graph (and seed) must
        return exactly equal outputs here."""
        z = np.zeros((self.num_slots,), np.float32)
        states = self.init_states()
        tick, self._tick = self._tick, -1
        try:
            if self._spec is not None:
                toks, counts, states = self.step_spec(z, z, z, z, states)
                outs = [toks, counts]
            else:
                sampled, states = self.step(z, z, z, states)
                outs = [sampled]
        finally:
            self._tick = tick
        keys = list(self.state_names) + list(self.draft_state_keys)
        return outs + [states[k].cpu().numpy() for k in keys]


def greedy_decode(program, prompt, max_new_tokens, eos_id=None,
                  max_len=None):
    """Reference single-request greedy decode: teacher-force the prompt
    through ``program`` one token per step, then feed each argmax sample
    back, alone in slot 0.  The engine is held to this loop's output
    bitwise, whatever company a request keeps in the slot pool."""
    states = program.init_states()
    n = program.num_slots
    tokens = np.zeros((n,), np.float32)
    pos = np.zeros((n,), np.float32)
    valid = np.zeros((n,), np.float32)
    valid[0] = 1.0
    prompt = list(prompt)
    if not prompt:
        raise MXNetError("greedy_decode needs a non-empty prompt")
    tokens[0] = prompt[0]
    out, p, i = [], 0, 1
    while len(out) < max_new_tokens:
        if max_len is not None and p >= max_len:
            break
        pos[0] = p
        sampled, states = program.step(tokens, pos, valid, states)
        p += 1
        if i < len(prompt):             # still consuming the prompt
            tokens[0] = prompt[i]
            i += 1
            continue
        tok = int(sampled[0])
        out.append(tok)
        tokens[0] = sampled[0]
        if eos_id is not None and tok == eos_id:
            break
    return np.asarray(out, dtype=np.int64)


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    return float(sorted_vals[min(len(sorted_vals) - 1,
                                 int(len(sorted_vals) * q))])


class _DecodeTelemetry(object):
    """Decode engine's instrument bundle (mxnet_serve_decode_*), built
    only when telemetry is enabled — the reference's, under the same
    names and labels, less the replica set's and the AOT cache's
    families.  Shares the admission families with the one-shot engine
    (AdmissionController reads ``admitted``/``rejected``/``shed``/
    ``regulator_shed``/``expired``/``queue_depth`` off this object) so
    both engine kinds aggregate into one serving picture; per-engine
    gauges are reclaimed at close()."""

    def __init__(self, engine):
        reg = _telemetry.registry()
        self.engine_label = str(next(_ENGINE_SEQ))
        self.closed = False
        self.requests = reg.counter(
            "mxnet_serve_requests_total", "serving requests submitted")
        self.admitted = reg.counter(
            "mxnet_serve_admitted_total", "requests admitted")
        self.rejected = reg.counter(
            "mxnet_serve_rejected_total",
            "requests rejected with QueueFullError backpressure")
        self.shed = reg.counter(
            "mxnet_serve_shed_total",
            "requests shed under the shed-oldest overload policy")
        self.regulator_shed = reg.counter(
            "mxnet_serve_regulator_shed_total",
            "requests shed cost-aware by the overload regulator's "
            "tightened queue limit — deliberately NOT part of the "
            "queue-saturation burn numerator (the regulator's own "
            "sheds must not re-fire the rule it is resolving)")
        self.expired = reg.counter(
            "mxnet_serve_expired_total",
            "requests expired past their deadline while queued")
        queue_depth_fam = reg.gauge(
            "mxnet_serve_queue_depth",
            "pending admission-queue depth per engine",
            labelnames=("engine",))
        self.queue_depth = queue_depth_fam.labels(
            engine=self.engine_label)
        self.tokens = reg.counter(
            "mxnet_serve_decode_tokens_total",
            "tokens generated by continuous-batching decode engines")
        self.steps = reg.counter(
            "mxnet_serve_decode_steps_total",
            "decode step-program dispatches (each steps every live "
            "slot once)")
        # slot-occupancy decomposition of every step dispatch: the
        # persistent step always computes num_slots rows, so each
        # dispatch splits exactly into live and dead rows
        self.slot_steps_live = reg.counter(
            "mxnet_serve_decode_live_slot_steps_total",
            "slot-steps computed for LIVE slots (a seated request's "
            "row advanced one position) across decode step dispatches")
        self.slot_steps_dead = reg.counter(
            "mxnet_serve_decode_dead_slot_steps_total",
            "slot-steps computed for DEAD slots (valid=0 rows riding "
            "the fixed-extent persistent step) across decode step "
            "dispatches")
        # coalesced-prefill element split, per prompt bucket
        self.prefill_live_elems = reg.counter(
            "mxnet_serve_decode_prefill_live_elements_total",
            "prompt positions carrying real tokens in coalesced "
            "prefill dispatches, per prompt bucket",
            labelnames=("bucket",))
        self.prefill_padded_elems = reg.counter(
            "mxnet_serve_decode_prefill_padded_elements_total",
            "padding positions (batch-row and sequence overhang) in "
            "coalesced prefill dispatches, per prompt bucket",
            labelnames=("bucket",))
        self._prefill_elem_handles = {}
        self.joins = reg.counter(
            "mxnet_serve_decode_joins_total",
            "requests that joined the running decode batch (slot "
            "assigned between steps — never a retrace)")
        self.steals = reg.counter(
            "mxnet_serve_decode_steals_total",
            "routed-but-unseated requests STOLEN by a sibling replica "
            "with free slots (cross-replica work stealing: a request "
            "queued behind a full pool re-offers instead of waiting "
            "out its pinned replica's generations)")
        self.leaves = reg.counter(
            "mxnet_serve_decode_leaves_total",
            "requests that left the decode batch, by how generation "
            "ended (eos / length / deadline / closed / cancelled)",
            labelnames=("reason",))
        # label handles resolved ONCE: leaves are hot-path
        self._leave = {r: self.leaves.labels(reason=r)
                       for r in ("eos", "length", "deadline", "closed",
                                 "cancelled")}
        self.evictions = reg.counter(
            "mxnet_serve_decode_evictions_total",
            "slot-resident requests evicted mid-generation by their "
            "deadline: the future resolves with the PARTIAL tokens "
            "and expired=True, and the slot frees for queued work")
        self.step_ms = reg.histogram(
            "mxnet_serve_decode_step_ms",
            "wall time of one decode iteration (deadline sweep + step "
            "dispatch + host bookkeeping), per engine and device "
            "replica",
            labelnames=("engine", "replica"),
            buckets=_telemetry.LATENCY_MS_BUCKETS)
        self.r_step_ms = self.step_ms.labels(engine=self.engine_label,
                                             replica=_REPLICA)
        # per-request tails: TTFT = submit -> first generated token,
        # TPOT = mean inter-token gap over a finished request
        ttft_fam = reg.histogram(
            "mxnet_serve_decode_ttft_seconds",
            "time to first token: submit -> first generated token id "
            "(queue wait + prefill + first step), per decode engine",
            labelnames=("engine",),
            buckets=_telemetry.LATENCY_S_BUCKETS)
        self.ttft = ttft_fam.labels(engine=self.engine_label)
        tpot_fam = reg.histogram(
            "mxnet_serve_decode_tpot_seconds",
            "inter-token latency: mean gap between consecutive "
            "generated tokens per finished request (>= 2 tokens), per "
            "decode engine",
            labelnames=("engine",),
            buckets=_telemetry.LATENCY_S_BUCKETS)
        self.tpot = tpot_fam.labels(engine=self.engine_label)
        # speculative decode plane, registered ONLY for spec engines (a
        # k=0 engine's scrape carries none of it) and reclaimed at close
        self.spec_drafted = None
        self._spec_fams = ()
        if getattr(engine, "_spec_k", 0):
            self.spec_drafted = reg.counter(
                "mxnet_serve_decode_spec_drafted_total",
                "draft tokens proposed by speculative decode steps "
                "(k per spec-eligible slot per dispatch)")
            self.spec_accepted = reg.counter(
                "mxnet_serve_decode_spec_accepted_total",
                "draft tokens ACCEPTED by target verification — the "
                "tokens that cost one target dispatch for k+1 "
                "positions instead of one dispatch each")
            self.spec_rejected = reg.counter(
                "mxnet_serve_decode_spec_rejected_total",
                "draft tokens rejected by target verification "
                "(speculative work thrown away)")
            spec_accept_fam = reg.histogram(
                "mxnet_serve_decode_spec_accept_rate",
                "per-dispatch draft acceptance fraction "
                "(accepted / drafted over the step's spec-eligible "
                "slots), per decode engine",
                labelnames=("engine",),
                buckets=_telemetry.RATIO_BUCKETS)
            self.spec_accept = spec_accept_fam.labels(
                engine=self.engine_label)
            spec_tps_fam = reg.gauge(
                "mxnet_serve_decode_spec_tokens_per_step",
                "mean committed tokens PER SLOT per speculative step "
                "over the engine lifetime (1.0 = no speculative win; "
                "the ceiling is k+1 — occupancy does not move this "
                "number), per decode engine",
                labelnames=("engine",))
            self.spec_tps = spec_tps_fam.labels(
                engine=self.engine_label)
            self._spec_fams = (spec_accept_fam, spec_tps_fam)
        self.slots_fam = reg.gauge(
            "mxnet_serve_decode_slots",
            "slot-pool capacity per decode engine and device replica",
            labelnames=("engine", "replica"))
        self.occupied_fam = reg.gauge(
            "mxnet_serve_decode_slots_occupied",
            "slots currently generating per decode engine and device "
            "replica — occupied/capacity is decode's batch-occupancy "
            "analog, and the router's most-free-slots signal",
            labelnames=("engine", "replica"))
        compile_fam = reg.gauge(
            "mxnet_serve_compile_count",
            "bucket programs built so far, per engine",
            labelnames=("engine",))
        self.compile_count = compile_fam.labels(
            engine=self.engine_label)
        mem_pred_fam, mem_meas_fam = memory_metric_families(reg)
        self.mem_predicted = mem_pred_fam.labels(
            engine=self.engine_label)
        self._mem_meas_fam = mem_meas_fam
        self._mem_measured = None
        self._mem_probe_ok = True
        self._engine_gauge_fams = (queue_depth_fam, compile_fam,
                                   ttft_fam, tpot_fam,
                                   mem_pred_fam, mem_meas_fam) \
            + self._spec_fams
        self._replica_fams = (self.slots_fam, self.occupied_fam,
                              self.step_ms)
        self._engine = weakref.ref(engine)
        reg.register_callback(self._refresh)

    def leave(self, reason):
        handle = self._leave.get(reason)
        (handle if handle is not None
         else self.leaves.labels(reason=reason)).inc()

    def prefill_elems(self, bucket, live, padded):
        """Count one coalesced prefill dispatch's element split under
        its prompt-bucket label (handles memoized)."""
        h = self._prefill_elem_handles.get(bucket)
        if h is None:
            b = str(bucket)
            h = (self.prefill_live_elems.labels(bucket=b),
                 self.prefill_padded_elems.labels(bucket=b))
            self._prefill_elem_handles[bucket] = h
        if live:
            h[0].inc(live)
        if padded:
            h[1].inc(padded)

    def close(self):
        self.closed = True
        _telemetry.registry().unregister_callback(self._refresh)
        self._remove_engine_series()

    def _remove_engine_series(self):
        for fam in self._engine_gauge_fams:
            fam.remove(engine=self.engine_label)
        for fam in self._replica_fams:
            for values, _inst in fam.series():
                if values[0] == self.engine_label:
                    fam.remove(*values)

    def _refresh(self, reg):
        eng = self._engine()
        if eng is None:
            reg.unregister_callback(self._refresh)
            self._remove_engine_series()
            return
        self.compile_count.set(eng.programs_built)
        refresh_memory_gauges(self, eng)
        eff = getattr(eng, "_eff", None)
        if eff is not None:
            eff.refresh()
        if self.spec_drafted is not None:
            # GIL-atomic int reads: a collect-time callback must not
            # take scheduler locks
            steps, toks = eng._spec_slot_steps, eng._spec_accepted
            if steps:
                self.spec_tps.set((toks + steps) / float(steps))
        el = self.engine_label
        self.slots_fam.labels(engine=el,
                              replica=_REPLICA).set(eng.num_slots)
        self.occupied_fam.labels(engine=el, replica=_REPLICA).set(
            sum(1 for s in eng._rep.slots if s is not None))


class DecodeReplica(object):
    """The engine's slot pool: the step program, the device-resident
    per-slot state and the host mirror vectors (counterpart of
    ``mxnet_tpu/serving/replica.py`` DecodeReplica; the port runs one).
    Touched only by the scheduler thread."""

    def __init__(self, program):
        n = program.num_slots
        self.program = program
        self.slots = [None] * n
        self.tokens_np = np.zeros((n,), np.float32)
        self.pos_np = np.zeros((n,), np.float32)
        self.valid_np = np.zeros((n,), np.float32)
        self.reset_np = np.zeros((n,), np.float32)
        # speculative eligibility: 1 while a slot generates past its
        # prompt; ineligible slots commit one position per spec step
        self.spec_np = np.zeros((n,), np.float32)
        self.states = program.init_states()
        self.prefill_caches = {}     # prompt bucket -> ProgramCache
        self.prefill_buckets = ()

    def occupied(self):
        return [i for i, s in enumerate(self.slots) if s is not None]


class DecodeEngine(object):
    """Continuous-batching autoregressive decode over one frozen step
    graph (the module docstring has the architecture).

    Parameters
    ----------
    step_sym : Symbol with outputs ``[logits] + next_states``.
    arg_params, aux_params : weights as NDArrays ({name: NDArray}).
    state_info : list of ``{"name", "shape"[, "dtype"][, "cache"]}`` —
        per-slot state buffers, in the order the step graph returns
        their next values; ``"cache": True`` declares a KV cache the
        speculative commit writes row by row.
    num_slots, max_len : slot-pool geometry (defaults from
        ``MXNET_DECODE_SLOTS`` / ``MXNET_DECODE_MAX_LEN``).
    eos_id : sampling this id ends a request with reason "eos".
    prefill_sym : optional prompt-consumption graph with outputs
        ``[logits at the last live position] + state rows`` over the
        arguments ``prefill_data_name`` ((B, T) prompt ids, T padded onto
        pow2 buckets) and ``prefill_len_name`` ((B,) live prompt
        lengths).  Either one length-polymorphic Symbol or a callable
        ``T -> Symbol``.  Run through one :class:`~.buckets.ProgramCache`
        per prompt bucket; its state rows are written into the slot.
        Without it, prompts are teacher-forced token by token.
    sampler : the token-selection head (default :class:`GreedySampler`);
        :class:`TemperatureSampler` samples on the device after the step.
    overload_policy : ``"reject"`` or ``"shed-oldest"`` (default
        ``MXNET_SERVE_OVERLOAD_POLICY``).
    ctx : the device; the first CUDA card when None (raises without
        one); ``cpu()`` for the CPU.
    draft_sym, draft_arg_params, draft_aux_params, draft_state_info,
    spec_k : speculative draft-k-verify (``spec_k`` defaults to
        ``MXNET_DECODE_SPEC_K``; 0 = the single-token engine).
    """

    def __init__(self, step_sym, arg_params, aux_params, state_info,
                 token_name="token", pos_name="pos", valid_name="valid",
                 num_slots=None, max_len=None, eos_id=None,
                 prefill_sym=None, prefill_data_name="prompt",
                 prefill_len_name="plen",
                 max_queue=None, default_deadline_ms=None,
                 overload_policy=None, ctx=None,
                 dtype=np.float32, start=True, sampler=None,
                 draft_sym=None, draft_arg_params=None,
                 draft_aux_params=None, draft_state_info=None,
                 spec_k=None):
        from .. import config
        self._ctx = default_context(ctx)
        if num_slots is None:
            num_slots = config.get("MXNET_DECODE_SLOTS")
        if max_len is None:
            max_len = config.get("MXNET_DECODE_MAX_LEN")
        if spec_k is None:
            spec_k = config.get("MXNET_DECODE_SPEC_K")
        spec_k = int(spec_k)
        if spec_k < 0:
            raise MXNetError("spec_k must be >= 0, got %d" % spec_k)
        if spec_k > 0 and draft_sym is None:
            raise MXNetError(
                "spec_k=%d needs a draft model: pass draft_sym= (and its "
                "params/state_info)" % spec_k)
        self._spec_k = spec_k if draft_sym is not None else 0
        if self._spec_k and sampler is not None and not sampler.greedy \
                and type(sampler).spec_logits is Sampler.spec_logits:
            # refused at construction, like every other spec contract
            # violation, not inside the first step
            raise MXNetError(
                "speculative decode needs the sampler's verification "
                "distribution: %s must implement spec_logits() (see "
                "TemperatureSampler), or use spec_k=0"
                % type(sampler).__name__)
        self._sampler = sampler if sampler is not None else GreedySampler()
        if max_queue is None:
            max_queue = config.get("MXNET_SERVE_MAX_QUEUE")
        if default_deadline_ms is None:
            default_deadline_ms = config.get(
                "MXNET_SERVE_DEFAULT_DEADLINE_MS")
        if overload_policy is None:
            overload_policy = config.get("MXNET_SERVE_OVERLOAD_POLICY")
        if num_slots < 1:
            raise MXNetError("num_slots must be >= 1, got %d" % num_slots)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self._dtype = np.dtype(dtype)
        self._default_deadline_s = float(default_deadline_ms) / 1e3
        self.analysis_report = None
        self.step_verdict = None
        self.draft_verdict = None
        if config.get("MXNET_ANALYSIS_ON"):
            self.step_verdict, self.analysis_report = self._preflight(
                step_sym, state_info, token_name, pos_name, valid_name,
                config.get("MXNET_ANALYSIS_STRICT"), what="step")
            if self._spec_k:
                # the draft's states ride the SAME slot pool: the same
                # soundness bar as the target's
                self.draft_verdict, _ = self._preflight(
                    draft_sym, draft_state_info or [], token_name,
                    pos_name, valid_name,
                    config.get("MXNET_ANALYSIS_STRICT"), what="draft")
        if self._spec_k:
            self._check_draft_heads(step_sym, draft_sym, state_info,
                                    draft_state_info or [], token_name,
                                    pos_name, valid_name)
        self.opt_plan = self.selection = self.draft_opt_plan = None
        if config.get("MXNET_SERVE_OPTIMIZE") \
                and config.get("MXNET_OPT_SELECT_KERNELS") \
                and config.get("MXNET_ANALYSIS_ON"):
            step_sym, self.opt_plan, self.selection = self._optimize_step(
                step_sym, state_info, token_name, pos_name, valid_name,
                what="step")
            if self._spec_k:
                draft_sym, self.draft_opt_plan, _sel = self._optimize_step(
                    draft_sym, draft_state_info or [], token_name,
                    pos_name, valid_name, what="draft")
        self.served_sym = step_sym
        self.served_draft_sym = draft_sym if self._spec_k else None
        self._spec_cfg = None
        if self._spec_k:
            self._spec_cfg = _spec_mod.SpecConfig(
                self._spec_k, draft_sym, draft_arg_params=draft_arg_params,
                draft_aux_params=draft_aux_params,
                draft_state_info=draft_state_info, token_name=token_name,
                pos_name=pos_name, valid_name=valid_name)
            self._spec_cfg.build(self.num_slots, state_info, dtype,
                                 device=self._ctx.device)
        self._prefill_data_name = prefill_data_name
        self._prefill_len_name = prefill_len_name
        self._coalesce = bool(config.get("MXNET_DECODE_COALESCE_PREFILL"))
        self._prefill_dispatches = 0
        # prompt buckets: pow2 up to max_len; coalesced prefill also
        # dispatches at pow2 BATCH buckets, serial prefill at batch 1
        prefill_buckets = ()
        if prefill_sym is not None:
            prefill_buckets = tuple(1 << i for i in range(
                _next_pow2(self.max_len).bit_length()))
        self._prefill_batches = (tuple(1 << i for i in range(
            _next_pow2(self.num_slots).bit_length()))
            if self._coalesce else (1,))
        self.memory_plan = None
        if config.get("MXNET_MEMORY_PLAN") \
                and config.get("MXNET_ANALYSIS_ON"):
            self._memory_preflight(
                step_sym, state_info, arg_params, aux_params, token_name,
                pos_name, valid_name, prefill_sym, prefill_buckets,
                draft_sym, draft_state_info, draft_arg_params,
                draft_aux_params, config.get("MXNET_ANALYSIS_STRICT"))
        self._rep = DecodeReplica(StepProgram(
            step_sym, arg_params, aux_params, state_info, self.num_slots,
            token_name=token_name, pos_name=pos_name,
            valid_name=valid_name, ctx=self._ctx, dtype=dtype,
            sampler=self._sampler, spec=self._spec_cfg))
        if prefill_sym is not None:
            self._attach_prefill(self._rep, prefill_sym, arg_params,
                                 aux_params, dtype, prefill_buckets)
        self._spec_steps = 0        # dispatches with >= 1 spec slot
        self._spec_slot_steps = 0   # per-slot spec steps
        self._spec_drafted = self._spec_accepted = 0
        # telemetry bundle, timeline ring and efficiency ledger: None
        # when off (zero instrument calls on the scheduler's path)
        self._tm = (_DecodeTelemetry(self)
                    if _telemetry.enabled() else None)
        self._tl = (_telemetry.timeline.get()
                    if _telemetry.timeline.enabled() else None)
        # the step program is priced once here (memoized on it); the
        # prefill buckets as their programs are built
        self._eff = None
        if self._tm is not None and _goodput.enabled():
            self._eff = _goodput.EngineEfficiency(
                "decode", self._tm.engine_label)
            self._eff.add_replica(_REPLICA, ctx=self._ctx)
            _goodput.price_step_program(self._rep.program)
        self._trace_chain = (_telemetry.chain_from_config()
                             if self._tm is not None else None)
        self._owns_http_server = (_telemetry.server.engine_acquire()
                                  if self._tm is not None else False)
        self._adm = AdmissionController(max_queue=max_queue,
                                        overload_policy=overload_policy,
                                        telemetry=self._tm)
        self._lock = threading.Lock()
        self._tasks = collections.deque()
        self._step_ms = collections.deque(maxlen=4096)
        self._lat_ms = collections.deque(maxlen=4096)
        self._steps = self._joins = self._leaves = 0
        self._evictions = self._tokens_out = self._requests_served = 0
        self._abort = False
        # heartbeat, flight-recorder registration and the default alert
        # rules, registered last (see ServingEngine)
        self._hb_t = time.monotonic()
        self._hb_busy = False
        self._owns_recorder = False
        self._alert_owner = None
        self._obs_name = None
        if self._tm is not None:
            self._obs_name = "decode.%s" % self._tm.engine_label
            _telemetry.recorder.register_heartbeat(self._obs_name,
                                                   self._heartbeat)
            _telemetry.recorder.register_engine(self._obs_name, self)
            self._owns_recorder = _telemetry.recorder.recorder_acquire()
            if config.get("MXNET_TELEMETRY_ALERTS"):
                self._alert_owner = \
                    _telemetry.register_engine_default_rules(
                        "decode", self._tm.engine_label)
        self._worker = None
        if start:
            self.start()

    @property
    def program(self):
        return self._rep.program

    def _attach_prefill(self, rep, prefill_sym, arg_params, aux_params,
                        dtype, buckets):
        """One prefill ProgramCache per prompt bucket: a callable
        ``T -> Symbol`` is built once per bucket (an unrolled graph bakes
        its length in); a Symbol is one length-polymorphic graph that
        every bucket shares."""
        rep.prefill_buckets = tuple(buckets)
        if not isinstance(prefill_sym, sym.Symbol) and callable(prefill_sym):
            for b in buckets:
                rep.prefill_caches[b] = self._build_prefill(
                    prefill_sym(b), arg_params, aux_params, dtype,
                    rep.program)
        else:
            shared = self._build_prefill(prefill_sym, arg_params,
                                         aux_params, dtype, rep.program)
            for b in buckets:
                rep.prefill_caches[b] = shared

    def _build_prefill(self, psym, arg_params, aux_params, dtype, program):
        """Wrap one prefill graph with the sampling head: outputs become
        [first sampled token id] + state rows under the greedy head, or
        [last-position logits] + state rows for a stochastic sampler
        (sampled on the device by ``StepProgram.sample_tokens``, from the
        step's noise stream)."""
        if len(psym) != 1 + len(program.state_names):
            raise MXNetError(
                "prefill graph has %d outputs; expected 1 (logits at "
                "the last valid position) + %d state rows"
                % (len(psym), len(program.state_names)))
        head = (sym.argmax(psym[0], axis=1,
                           name="__decode_prefill_sample__")
                if self._sampler.greedy else psym[0])
        wrapped = sym.Group([head] + [psym[i] for i in range(1, len(psym))])
        return ProgramCache(
            wrapped, arg_params, aux_params,
            data_names=[self._prefill_data_name, self._prefill_len_name],
            ctx=self._ctx, dtype=dtype)

    def _check_draft_heads(self, step_sym, draft_sym, state_info,
                           draft_state_info, token_name, pos_name,
                           valid_name):
        """Draft and target must score the SAME vocabulary: acceptance
        compares them index for index."""
        def logits_shape(sym_, infos):
            n = self.num_slots
            arg_names = set(sym_.list_arguments())
            shapes = {token_name: (n,)}
            for info in infos:
                shapes[info["name"]] = (n,) + tuple(info["shape"])
            for extra in (pos_name, valid_name):
                if extra in arg_names:
                    shapes[extra] = (n,)
            return tuple(sym_.infer_shape(**shapes)[1][0])
        try:
            t_shape = logits_shape(step_sym, state_info)
            d_shape = logits_shape(draft_sym, draft_state_info)
        except Exception as e:
            warnings.warn("DecodeEngine: cannot infer draft/target head "
                          "shapes (%r); the head-compatibility check is "
                          "skipped" % (e,))
            return
        if t_shape != d_shape:
            raise MXNetError(
                "speculative decode: target head scores %s but the draft "
                "head scores %s — draft and target must share one "
                "vocabulary" % (t_shape, d_shape))

    def _slot_spec(self, step_sym, state_info, token_name, pos_name,
                   valid_name):
        """Slot-pool shapes and dtypes of the step graph's per-slot
        inputs, and its state names (the pad-dirty seeds)."""
        n = self.num_slots
        arg_names = set(step_sym.list_arguments())
        shapes = {token_name: (n,)}
        dtypes = {token_name: np.dtype(np.float32)}
        state_names = []
        for info in state_info:
            shapes[info["name"]] = (n,) + tuple(info["shape"])
            dtypes[info["name"]] = np.dtype(info.get("dtype")
                                            or self._dtype)
            state_names.append(info["name"])
        for extra in (pos_name, valid_name):
            if extra in arg_names:
                shapes[extra] = (n,)
                dtypes[extra] = np.dtype(np.float32)
        return shapes, dtypes, state_names

    def _preflight(self, step_sym, state_info, token_name, pos_name,
                   valid_name, strict, what="step"):
        """Construction-time soundness lint: the masked step must be
        row-local along the SLOT axis with state seeded pad-dirty
        (analysis.check_decode_step).  Returns (verdict, report)."""
        from ..analysis import check_decode_step, AnalysisError
        shapes, _dtypes, state_names = self._slot_spec(
            step_sym, state_info, token_name, pos_name, valid_name)
        verdict, report = check_decode_step(
            step_sym, shapes, state_names=state_names,
            valid_name=valid_name if valid_name in shapes else None)
        if report.errors:
            if strict:
                report.raise_if_errors()
            warnings.warn("DecodeEngine: %s-graph verification "
                          "failed:\n%s" % (what, report.format()))
            return verdict, report
        if verdict == "cross-position":
            detail = "\n".join("  " + str(d) for d in report.warnings) \
                or "  (see report)"
            msg = ("[padding] DecodeEngine: %s graph is cross-position "
                   "along the SLOT axis — co-resident requests (and stale "
                   "state in freed slots) would contaminate each other's "
                   "tokens:\n%s" % (what, detail))
            if strict:
                raise AnalysisError(msg)
            warnings.warn(msg + "\ncontinuing because "
                          "MXNET_ANALYSIS_STRICT=0; decoded output "
                          "WILL differ from single-request decode")
        return verdict, report

    def _memory_preflight(self, step_sym, state_info, arg_params,
                          aux_params, token_name, pos_name, valid_name,
                          prefill_sym, prefill_buckets, draft_sym,
                          draft_state_info, draft_arg_params,
                          draft_aux_params, strict):
        """The OOM preflight and the donation gate (analysis/memory.py).

        The step program is priced at slot-pool shapes with the pool's
        state-for-state donation (state ``i`` aliases output ``1+i``, as
        the step donates its state buffers); an UNSOUND donation (a state
        read by a node not ordered before its aliasing next-state write)
        warns with the node named, or raises under strict.  A speculative
        engine prices the draft step on top (both models and pools are
        resident in a dispatch).  Prefill is priced at its largest
        (batch, prompt) bucket PLUS the resident slot pool.  Over the
        device budget warns naming the program, its bytes and how many
        slots would fit; ``MXNET_ANALYSIS_STRICT=1`` raises.  All before
        any program runs."""
        from ..analysis import AnalysisError
        from ..analysis.memory import (plan_memory, plan_digest,
                                       device_memory_budget, format_bytes)
        try:
            n = self.num_slots

            def price_step(sym_, infos, a_params, x_params):
                arg_names = set(sym_.list_arguments())
                shapes = {token_name: (n,)}
                donate, names = {}, []
                for i, info in enumerate(infos):
                    shapes[info["name"]] = (n,) + tuple(info["shape"])
                    names.append(info["name"])
                    donate[info["name"]] = 1 + i
                for extra in (pos_name, valid_name):
                    if extra in arg_names:
                        shapes[extra] = (n,)
                dtypes = {k: self._dtype for k in shapes}
                for src in (a_params or {}), (x_params or {}):
                    for k, v in src.items():
                        dt = getattr(v, "dtype", None)
                        if dt is not None:
                            dtypes.setdefault(k, dt)
                plan, _rep = plan_memory(sym_, shapes, dtypes=dtypes,
                                         donate=donate, state_names=names)
                return plan

            plan = price_step(step_sym, state_info, arg_params, aux_params)
            if not plan:
                return
            dplan = None
            if self._spec_k and draft_sym is not None:
                dplan = price_step(draft_sym, draft_state_info or [],
                                   draft_arg_params, draft_aux_params)
            # the slot pool the step's inputs already hold stays resident
            # under prefill too
            pool = sum(int(np.prod((n,) + tuple(info["shape"])))
                       * self._dtype.itemsize for info in state_info)
            per_slot = pool // n

            def row(label, p):
                return {"program": label,
                        "peak_bytes": p["peak_bytes"],
                        "param_bytes": p["param_bytes"],
                        "transient_peak_bytes": p["transient_peak_bytes"],
                        "inplace_savings_bytes":
                            p["inplace_savings_bytes"]}

            programs = [row("step", plan)]
            need = plan["peak_bytes"]
            offender = "step"
            donation = {"step": plan["donation"]}
            if dplan:
                programs.append(row("draft", dplan))
                need += dplan["peak_bytes"]
                offender = "step+draft"
                donation["draft"] = dplan["donation"]
            if prefill_sym is not None and prefill_buckets:
                b_top = max(prefill_buckets)
                bb = max(self._prefill_batches)
                psym = prefill_sym
                if not isinstance(psym, sym.Symbol) and callable(psym):
                    psym = psym(b_top)
                parg = set(psym.list_arguments())
                pshapes = {}
                if self._prefill_data_name in parg:
                    pshapes[self._prefill_data_name] = (bb, b_top)
                if self._prefill_len_name in parg:
                    pshapes[self._prefill_len_name] = (bb,)
                pdtypes = {}
                for src in (arg_params or {}), (aux_params or {}):
                    for k, v in src.items():
                        dt = getattr(v, "dtype", None)
                        if dt is not None:
                            pdtypes.setdefault(k, dt)
                pplan, _rep = plan_memory(psym, pshapes, dtypes=pdtypes)
                if pplan:
                    label = "prefill[b%dxT%d]" % (bb, b_top)
                    r = row(label, pplan)
                    r["peak_bytes"] = pplan["peak_bytes"] + pool
                    programs.append(r)
                    if r["peak_bytes"] > need:
                        need = r["peak_bytes"]
                        offender = label
            mem = {
                "enabled": True,
                "programs": programs,
                "predicted_peak_bytes": need,
                "param_bytes": plan["param_bytes"],
                "pool_bytes": pool,
                "per_slot_bytes": per_slot,
                "offender": offender,
                "sharded": False,
                "donation": donation,
            }
            mem["digest"] = plan_digest(
                {k: mem[k] for k in ("programs", "predicted_peak_bytes",
                                     "sharded", "donation")})
            budget = device_memory_budget(self._ctx)
            mem["budget_bytes"] = budget
            mem["budget_ok"] = (None if budget is None else need <= budget)
            mem["max_slots_fit"] = (
                max(0, int((budget - (need - pool)) // per_slot))
                if budget is not None and per_slot > 0 else None)
            self.memory_plan = mem
            bad = [(label, d) for label, d in sorted(donation.items())
                   if d is not None and not d["accepted"]]
            if bad:
                detail = "\n".join(
                    "  [%s] %s" % (label, reason)
                    for label, d in bad for reason in d["reasons"])
                msg = ("[memory] DecodeEngine slot-pool donation is "
                       "UNSOUND — an in-place next-state write would "
                       "clobber a state buffer before its last read:"
                       "\n%s" % detail)
                if strict:
                    raise AnalysisError(msg)
                warnings.warn(msg + "\ncontinuing because "
                              "MXNET_ANALYSIS_STRICT=0; the engine "
                              "does NOT donate these buffers safely")
            if mem["budget_ok"] is False:
                fit = mem["max_slots_fit"]
                msg = ("DecodeEngine memory preflight: program %r "
                       "predicts peak %s (slot pool %s for %d slots "
                       "+ params %s) but the device budget is %s — "
                       "the warm set cannot fit%s; shrink num_slots/"
                       "max_len or raise MXNET_MEMORY_BUDGET_BYTES "
                       "(priced before any program runs)"
                       % (offender, format_bytes(need),
                          format_bytes(pool), n,
                          format_bytes(plan["param_bytes"]),
                          format_bytes(budget),
                          (" (at most %d slots fit)" % fit
                           if fit is not None else "")))
                if strict:
                    raise AnalysisError("[memory] " + msg)
                warnings.warn(msg)
        except AnalysisError:
            raise
        except Exception as e:      # planner crash must never block
            warnings.warn("DecodeEngine: memory preflight crashed "
                          "(%r); continuing without a memory plan"
                          % (e,))

    def _optimize_step(self, step_sym, state_info, token_name, pos_name,
                       valid_name, what="step"):
        """Run the kernel-selection pipeline
        (``analysis.SELECT_OPT_PASSES``) over the step graph under the
        SAME spec the preflight uses — slot-pool shapes, slot padded
        axis, state inputs seeded pad-DIRTY — so a selection is adopted
        only via an accepted verdict-gated OptPlan.  Constants fold on
        the engine's device.  Returns ``(graph, plan, selection)``, the
        graph being what StepProgram should run (the input graph on
        rejection or crash)."""
        from ..analysis import optimize_graph, SELECT_OPT_PASSES
        try:
            shapes, dtypes, state_names = self._slot_spec(
                step_sym, state_info, token_name, pos_name, valid_name)
            plan = optimize_graph(
                step_sym, data_shapes=shapes, dtypes=dtypes,
                pad_axes={"slot": {name: 0 for name in shapes}},
                valid_lengths=({"slot": valid_name}
                               if valid_name in shapes else None),
                pad_dirty=tuple(state_names), passes=SELECT_OPT_PASSES,
                device=self._ctx.device)
        except Exception as e:    # optimizer crash must never block
            warnings.warn("DecodeEngine: %s-graph optimization crashed "
                          "(%r); serving the unmodified graph" % (what, e))
            return step_sym, None, None
        if plan.accepted and plan.symbol is not None and plan.rewrites:
            selection = [{"op": "_cache_write_row", "site": a.node}
                         for a in plan.actions if a.kind == "select"]
            return plan.symbol, plan, selection
        if not plan.accepted:
            warnings.warn("DecodeEngine: %s-graph optimization rejected "
                          "(%s); serving the unmodified graph"
                          % (what, plan.reason))
        return step_sym, plan, None

    # ---------------------------------------------------------- lifecycle
    def start(self):
        if self._adm.closed:
            raise EngineClosedError(
                "engine is closed; build a new DecodeEngine")
        if self._worker is None:
            self._worker = threading.Thread(target=self._run,
                                            name="mxnet-decode-worker",
                                            daemon=True)
            self._worker.start()
        return self

    def close(self, drain=True):
        """Stop admitting.  With ``drain``, queued AND slot-resident
        requests run to completion first; otherwise queued futures fail
        with EngineClosedError and in-flight requests resolve with their
        PARTIAL tokens (finish_reason "closed")."""
        if not drain:
            self._abort = True
        self._adm.close(drain=drain)
        if self._worker is not None:
            self._worker.join(timeout=None if drain else 60)
            if not self._worker.is_alive():
                self._worker = None
        elif drain:
            self._run()     # never started: drain on the caller's thread
        if self._eff is not None:
            self._eff.close()
            self._eff = None
        self._tl = None
        if self._tm is not None:
            self._tm.close()
        if self._obs_name is not None:
            _telemetry.recorder.unregister_heartbeat(self._obs_name)
            _telemetry.recorder.unregister_engine(self._obs_name)
            self._obs_name = None
        if self._alert_owner is not None:
            _telemetry.default_manager().remove_owner(self._alert_owner)
            self._alert_owner = None
        if self._owns_recorder:
            token, self._owns_recorder = self._owns_recorder, False
            _telemetry.recorder.recorder_release(token)
        if self._owns_http_server:
            self._owns_http_server = False
            _telemetry.server.engine_release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------- client
    def submit(self, prompt, max_new_tokens=None, deadline_ms=None,
               on_token=None, tenant=None):
        """Enqueue one generation request; returns a Future resolving to
        a :class:`DecodeResult`.

        ``prompt`` is a non-empty sequence of token ids; generation goes
        on until ``eos_id`` is sampled, ``max_new_tokens`` are out, the
        slot's ``max_len`` positions fill, or the deadline passes
        (partial result, ``expired=True``).  ``on_token`` is called with
        each generated id, in order (the exact prefix of the final
        tokens), from the scheduler thread; a raising callback fails only
        its own request.  ``tenant`` names the caller for the efficiency
        plane's per-tenant accounting."""
        if self._adm.closed:
            raise EngineClosedError("decode engine is closed")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("decode needs a non-empty prompt (feed at "
                             "least a BOS token)")
        if len(prompt) >= self.max_len:
            raise MXNetError(
                "prompt length %d leaves no room to generate within "
                "max_len=%d positions" % (len(prompt), self.max_len))
        cap = self.max_len - len(prompt)
        if max_new_tokens is None:
            max_new_tokens = cap
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        max_new_tokens = min(max_new_tokens, cap)
        if deadline_ms is None and self._default_deadline_s > 0:
            deadline_ms = self._default_deadline_s * 1e3
        deadline = None if not deadline_ms else \
            time.monotonic() + float(deadline_ms) / 1e3
        fut = Future()
        trace = None
        if self._tm is not None:
            self._tm.requests.inc()
            if self._trace_chain is not None:
                trace = _telemetry.LazyTrace(self._trace_chain,
                                             name="decode.request")
        req = DecodeRequest(prompt, max_new_tokens, fut, deadline=deadline,
                            trace=trace, on_token=on_token)
        if tenant is not None and self._eff is not None:
            req.tenant = self._eff.tenant_enter(tenant)
            if req.tenant is not None:
                fut.add_done_callback(
                    lambda f, _eff=self._eff, _t=req.tenant,
                    _t0=req.t_enqueue: _eff.tenant_done(_t, f, _t0))
        # padded-element price for the cost-ranked shed: the bucketed
        # prompt plus what the generation can occupy, k + 1 target
        # positions a token under speculation
        req.cost = int(_next_pow2(len(prompt))
                       + max_new_tokens * (self._spec_k + 1))
        # a deadline hit while queued COMPLETES the request with what it
        # has (nothing yet), as one hit mid-generation does
        req.on_expire = lambda exc, r=req: DecodeResult(
            r.tokens, "deadline", n_steps=r.n_steps,
            prompt_len=len(r.prompt))
        try:
            self._adm.admit(req)
        except Exception as e:
            if trace is not None:
                trace.abort(type(e).__name__)
            raise
        return fut

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 timeout=None):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           deadline_ms=deadline_ms).result(timeout=timeout)

    def _heartbeat(self):
        """Watchdog probe: progress age of the scheduler loop, busy
        when any slot is generating or work is queued."""
        now = time.monotonic()
        queued = len(self._adm)
        occupied = sum(1 for s in self._rep.slots if s is not None)
        return {"age_s": now - self._hb_t,
                "busy": bool(self._hb_busy or queued or occupied),
                "in_step": bool(self._hb_busy),
                "queued": queued, "slots_occupied": occupied,
                "kind": "decode",
                "engine": (self._tm.engine_label
                           if self._tm is not None else None)}

    # ------------------------------------------------------------- worker
    def _run(self):
        if self._ctx.device.type == "cuda":
            torch.cuda.set_device(self._ctx.device)
        self._single_run(self._rep)

    def _run_tasks(self):
        while self._tasks:
            fn, fut = self._tasks.popleft()
            try:
                fut.set_result(fn())
            except Exception as e:
                fut.set_exception(e)

    def _single_run(self, rep):
        """One thread admits, seats and steps the slot pool, and runs the
        engine's other device work (warmup) between steps."""
        while True:
            self._hb_t = time.monotonic()
            self._hb_busy = False
            try:
                self._run_tasks()
                if self._abort:
                    for i in rep.occupied():
                        self._finish_slot(rep, i, "closed")
                    return
                occ = rep.occupied()
                free = self.num_slots - len(occ)
                if not occ:
                    batch = self._adm.take(free, 0.0)
                    if batch is None:
                        self._run_tasks()
                        return          # closed and drained
                    self._hb_t = time.monotonic()
                    self._hb_busy = True
                    self._join_many(rep, batch)
                    continue
                self._hb_busy = True    # a wedged step must read busy
                # busy: admit without blocking a step, and keep queued
                # deadlines honest even when no slot is free
                if free:
                    polled = self._adm.poll(free)
                    if polled:
                        self._join_many(rep, polled)
                else:
                    self._adm.sweep()
                self._step_once(rep)
            except Exception as e:      # fail the batch, keep serving
                for i in rep.occupied():
                    req = rep.slots[i]
                    rep.slots[i] = None
                    rep.valid_np[i] = 0.0
                    if not req.future.done():
                        _fail_future(req.future, e)
                        if req.trace is not None:
                            req.trace.abort(type(e).__name__)
                rep.states = rep.program.init_states()
                for v in (rep.tokens_np, rep.pos_np, rep.reset_np,
                          rep.spec_np):
                    v.fill(0.0)

    def _join_many(self, rep, reqs):
        """Seat admitted requests in free slots BETWEEN steps.  Without a
        prefill graph: mark each slot's state rows for zeroing at the
        next step, stage the first prompt token, mark the slot valid.
        With one, prefill: coalesced, one dispatch per prompt bucket for
        every joiner of this iteration whose prompt pads into it; serial
        (``MXNET_DECODE_COALESCE_PREFILL=0``), one batch-1 dispatch per
        joiner, through the same code path."""
        seated = [req for req in reqs if self._seat_slot(rep, req)]
        if not seated:
            return
        if rep.prefill_caches:
            groups = []                 # [(bucket, [reqs])], seat order
            for req in seated:
                b = next(bk for bk in rep.prefill_buckets
                         if bk >= len(req.prompt))
                g = next((g for g in groups if g[0] == b),
                         None) if self._coalesce else None
                if g is None:
                    groups.append((b, [req]))
                else:
                    g[1].append(req)
            for b, grp in groups:
                self._prefill_group(rep, b, grp)
        else:
            for req in seated:
                slot = req.slot
                rep.reset_np[slot] = 1.0
                rep.tokens_np[slot] = req.prompt[0]
                rep.pos_np[slot] = 0.0
                req.prompt_i = 1
                # spec eligibility starts with the first sampling step,
                # the one that consumes the last prompt token
                rep.spec_np[slot] = (1.0 if req.prompt_i
                                     >= len(req.prompt) else 0.0)
        for req in seated:
            if req.slot is not None and rep.slots[req.slot] is req:
                self._check_finish(rep, req.slot)

    def _prefill_group(self, rep, bucket, group):
        """Every joiner whose prompt pads into ``bucket`` rides ONE
        dispatch at the next pow2 batch extent (dead rows padded with
        zero prompts and length 0, the rows warmup feeds); each request's
        state rows are written into its slot.  A failed dispatch fails
        the group's requests and nothing else."""
        bb = next(b for b in self._prefill_batches if b >= len(group))
        arr = np.zeros((bb, bucket), np.float32)
        lens = np.zeros((bb,), np.float32)
        for r_i, req in enumerate(group):
            plen = len(req.prompt)
            arr[r_i, :plen] = req.prompt
            lens[r_i] = plen
        t_pf0 = time.perf_counter()
        try:
            outs = rep.prefill_caches[bucket].run(
                {self._prefill_data_name: arr,
                 self._prefill_len_name: lens}, host=False)
            with self._lock:
                self._prefill_dispatches += 1
            with torch.no_grad():
                if self._sampler.greedy:
                    first = outs[0].float().cpu().numpy()
                else:
                    first = rep.program.sample_tokens(outs[0])
            rows_all = outs[1:]
        except Exception as e:
            for req in group:
                self._fail_seated(rep, req, e)
            return
        # element split + FLOPs ledger for this one dispatch: the
        # program computed bb*bucket positions, sum(prompt lengths) of
        # them real tokens
        live_elems = int(sum(len(r.prompt) for r in group))
        padded_elems = bb * bucket
        if self._tm is not None:
            self._tm.prefill_elems(bucket, live_elems,
                                   padded_elems - live_elems)
        if self._tl is not None:
            self._tl.complete("decode.prefill", "decode", "decode:0",
                              t_pf0, time.perf_counter(),
                              args={"bucket": bucket, "group": len(group)})
        if self._eff is not None:
            shape_key = tuple(sorted(
                (k, v.shape)
                for k, v in ((self._prefill_data_name, arr),
                             (self._prefill_len_name, lens))))
            useful = self._eff.record_batch(
                _REPLICA, rep.prefill_caches[bucket].flops_for(shape_key),
                live_elems, padded_elems)
            if useful:
                for req in group:
                    if req.tenant is not None:
                        req.uflops += (useful * len(req.prompt)
                                       // live_elems)
        for r_i, req in enumerate(group):
            rows = {name: rows_all[i][r_i]
                    for i, name in enumerate(rep.program.state_names)}
            self._commit_prefill(rep, req, rows, first[r_i])

    def _commit_prefill(self, rep, req, rows, first):
        """Write one request's prefill state rows into its slot and
        deliver its first generated token."""
        slot = req.slot
        rep.states = rep.program.write_row(rep.states, slot, rows)
        if self._spec_k:
            # the prefill graph made TARGET rows only; the draft never
            # saw this prompt and must not read the previous occupant's
            # rows: start it cold (its quality moves the accept rate,
            # never the stream)
            rep.states = rep.program.zero_row(rep.states, slot,
                                              which="draft")
            rep.spec_np[slot] = 1.0
        rep.reset_np[slot] = 0.0        # prefill rows are live data
        req.prompt_i = len(req.prompt)
        req.tokens.append(int(first))
        now = time.monotonic()
        req.t_first_tok = req.t_last_tok = now
        rep.tokens_np[slot] = first
        rep.pos_np[slot] = float(len(req.prompt))
        with self._lock:
            self._tokens_out += 1
        if self._tm is not None:
            self._tm.tokens.inc()
            self._tm.ttft.observe(now - req.t_enqueue)
        if req.on_token is not None:
            self._fire_on_token(rep, req, int(first))

    def _seat_slot(self, rep, req):
        """Claim a free slot for one admitted request; False when the
        request was cancelled before seating (counted as a leave)."""
        if not req.future.set_running_or_notify_cancel():
            if req.trace is not None:
                req.trace.abort("cancelled")
            with self._lock:
                self._leaves += 1
            if self._tm is not None:
                self._tm.leave("cancelled")
            return False
        slot = rep.slots.index(None)
        req.slot = slot
        req.t_join = time.perf_counter()
        rep.slots[slot] = req
        rep.valid_np[slot] = 1.0
        rep.spec_np[slot] = 0.0
        with self._lock:
            self._joins += 1
        if self._tm is not None:
            self._tm.joins.inc()
        if self._tl is not None:
            self._tl.instant("decode.join", "decode", "decode:0",
                             args={"slot": slot, "request": None,
                                   "prompt_len": len(req.prompt)})
        return True

    def _fail_seated(self, rep, req, exc):
        """Fail ONE seated request and free its slot; co-residents keep
        their generations."""
        slot = req.slot
        if slot is not None and rep.slots[slot] is req:
            rep.slots[slot] = None
            rep.valid_np[slot] = 0.0
            rep.spec_np[slot] = 0.0
        with self._lock:
            self._leaves += 1
        if self._tm is not None:
            self._tm.leave("error")
        if req.tenant is not None and req.uflops \
                and self._eff is not None:
            self._eff.tenant_useful(req.tenant, req.uflops)
            req.uflops = 0
        _fail_future(req.future, exc)
        if req.trace is not None:
            req.trace.abort(type(exc).__name__)

    def _fire_on_token(self, rep, req, tok):
        """Streaming hook: a raising callback evicts ONLY its own request.
        Returns False when the request was evicted."""
        try:
            req.on_token(int(tok))
            return True
        except Exception as e:
            self._fail_seated(rep, req, e)
            return False

    def _step_once(self, rep):
        t0 = time.perf_counter()
        now = time.monotonic()
        # per-iteration deadline check: an expired slot-resident request
        # completes with its partial tokens and frees the slot
        occ = []
        for i, req in enumerate(rep.slots):
            if req is None:
                continue
            if req.deadline is not None and now >= req.deadline:
                self._finish_slot(rep, i, "deadline")
            else:
                occ.append(i)
        if not occ:
            return
        if self._spec_k:
            toks_mat, counts, rep.states = rep.program.step_spec(
                rep.tokens_np, rep.pos_np, rep.valid_np, rep.spec_np,
                rep.states, reset=rep.reset_np)
            rep.reset_np.fill(0.0)
            if self._eff is not None:
                # FLOPs ledger before the slot advance (a slot finishing
                # this very step must still absorb its tenant share)
                cl = counts.tolist()
                committed = int(sum(cl[i] for i in occ))
                self._ledger_step(
                    rep, occ,
                    self._eff.record_spec_step(
                        _REPLICA, _goodput.price_step_program(rep.program),
                        len(occ), self.num_slots, committed,
                        self._spec_k + 1))
            new_tokens = self._advance_spec(rep, occ, toks_mat, counts)
        else:
            sampled, rep.states = rep.program.step(
                rep.tokens_np, rep.pos_np, rep.valid_np, rep.states,
                reset=rep.reset_np)
            rep.reset_np.fill(0.0)      # consumed: rows are zeroed now
            if self._eff is not None:
                self._ledger_step(
                    rep, occ,
                    self._eff.record_step(
                        _REPLICA, _goodput.price_step_program(rep.program),
                        len(occ), self.num_slots))
            sampled_l = sampled.tolist()
            new_tokens = 0
            t_tok = time.monotonic()    # one stamp serves every slot
            for i in occ:
                req = rep.slots[i]
                req.n_steps += 1
                rep.pos_np[i] += 1.0
                if req.prompt_i < len(req.prompt):
                    # teacher forcing: the sample is discarded, the next
                    # prompt token rides the next step
                    rep.tokens_np[i] = req.prompt[req.prompt_i]
                    req.prompt_i += 1
                else:
                    tok = sampled_l[i]
                    req.tokens.append(int(tok))
                    rep.tokens_np[i] = tok
                    new_tokens += 1
                    if req.t_first_tok is None:
                        req.t_first_tok = t_tok
                        if self._tm is not None:
                            self._tm.ttft.observe(t_tok - req.t_enqueue)
                    req.t_last_tok = t_tok
                    if req.on_token is not None \
                            and not self._fire_on_token(rep, req, tok):
                        continue    # evicted by its own callback
                self._check_finish(rep, i)
        t1 = time.perf_counter()
        dt_ms = (t1 - t0) * 1e3
        with self._lock:
            self._steps += 1
            self._tokens_out += new_tokens
            self._step_ms.append(dt_ms)
        if self._tl is not None:
            self._tl.complete("decode.step", "decode", "decode:0", t0, t1,
                              args={"live": len(occ),
                                    "tokens": new_tokens})
        if self._tm is not None:
            self._tm.steps.inc()
            if new_tokens:
                self._tm.tokens.inc(new_tokens)
            self._tm.r_step_ms.observe(dt_ms)
            self._tm.slot_steps_live.inc(len(occ))
            dead = self.num_slots - len(occ)
            if dead:
                self._tm.slot_steps_dead.inc(dead)

    def _ledger_step(self, rep, occ, useful):
        """Spread one step dispatch's useful FLOPs over the live slots
        for tenant accounting (integer shares; the remainder stays in
        the engine-level ledger, which is exact by construction)."""
        if not useful:
            return
        share = useful // len(occ)
        if not share:
            return
        for i in occ:
            req = rep.slots[i]
            if req.tenant is not None:
                req.uflops += share

    def _advance_spec(self, rep, occ, toks_mat, counts):
        """The variable-width slot advance: slot ``i`` committed
        ``counts[i]`` positions and ``toks_mat[i, :counts[i]]`` holds its
        accepted tokens in order.  Emission truncates at eos / max_new /
        max_len (a truncated slot always finishes); ``on_token`` fires
        once per emitted token, in order."""
        toks_l = toks_mat.tolist()
        counts_l = counts.tolist()
        new_tokens = drafted = accepted = spec_slots = 0
        t_tok = time.monotonic()
        for i in occ:
            req = rep.slots[i]
            req.n_steps += 1
            if req.prompt_i < len(req.prompt):
                # teacher forcing: one position committed; stage the next
                # prompt token
                rep.pos_np[i] += 1.0
                rep.tokens_np[i] = req.prompt[req.prompt_i]
                req.prompt_i += 1
                if req.prompt_i >= len(req.prompt):
                    rep.spec_np[i] = 1.0
                self._check_finish(rep, i)
                continue
            c = int(counts_l[i])
            spec_slots += 1
            drafted += self._spec_k
            accepted += c - 1
            cap = min(c, req.max_new - len(req.tokens),
                      self.max_len - int(rep.pos_np[i]))
            rep.pos_np[i] += float(c)
            evicted = False
            last = None
            for jj in range(cap):
                tok = int(toks_l[i][jj])
                req.tokens.append(tok)
                new_tokens += 1
                if req.t_first_tok is None:
                    req.t_first_tok = t_tok
                    if self._tm is not None:
                        self._tm.ttft.observe(t_tok - req.t_enqueue)
                req.t_last_tok = t_tok
                if req.on_token is not None \
                        and not self._fire_on_token(rep, req, tok):
                    evicted = True
                    break
                last = tok
                if self.eos_id is not None and tok == self.eos_id:
                    break
            if evicted:
                continue
            if last is not None:
                rep.tokens_np[i] = float(last)
            self._check_finish(rep, i)
        if spec_slots:
            with self._lock:
                self._spec_steps += 1
                self._spec_slot_steps += spec_slots
                self._spec_drafted += drafted
                self._spec_accepted += accepted
            if self._tm is not None and self._tm.spec_drafted \
                    is not None:
                self._tm.spec_drafted.inc(drafted)
                self._tm.spec_accepted.inc(accepted)
                self._tm.spec_rejected.inc(drafted - accepted)
                if drafted:
                    self._tm.spec_accept.observe(accepted
                                                 / float(drafted))
        return new_tokens

    def _check_finish(self, rep, slot):
        req = rep.slots[slot]
        if req is None or not req.tokens:
            return
        if self.eos_id is not None and req.tokens[-1] == self.eos_id:
            self._finish_slot(rep, slot, "eos")
        elif len(req.tokens) >= req.max_new:
            self._finish_slot(rep, slot, "length")
        elif rep.pos_np[slot] >= self.max_len:
            # no position left to consume the staged token at
            self._finish_slot(rep, slot, "length")

    def _finish_slot(self, rep, slot, reason):
        """Leave the batch between steps: deliver the result and mark the
        slot dead; its state rows stay as stale values until the next
        join zeroes them."""
        req = rep.slots[slot]
        rep.slots[slot] = None
        for v in (rep.valid_np, rep.tokens_np, rep.pos_np, rep.spec_np):
            v[slot] = 0.0
        now = time.monotonic()
        t1 = time.perf_counter()
        res = DecodeResult(req.tokens, reason, n_steps=req.n_steps,
                           prompt_len=len(req.prompt))
        if req.tenant is not None and req.uflops \
                and self._eff is not None:
            # the request's useful-FLOPs share goes to its tenant (tokens,
            # outcome and latency ride the future's done callback)
            self._eff.tenant_useful(req.tenant, req.uflops)
            req.uflops = 0
        if not req.future.cancelled():
            try:
                req.future.set_result(res)
            except Exception:
                pass
        with self._lock:
            self._leaves += 1
            self._requests_served += 1
            if reason == "deadline":
                self._evictions += 1
            self._lat_ms.append((now - req.t_enqueue) * 1e3)
        if self._tl is not None:
            self._tl.instant(
                "decode.evict" if reason == "deadline"
                else "decode.leave", "decode", "decode:0",
                args={"slot": slot, "reason": reason, "request": None,
                      "tokens": len(req.tokens)})
        if self._tm is not None:
            self._tm.leave(reason)
            if reason == "deadline":
                self._tm.evictions.inc()
            if len(req.tokens) >= 2 and req.t_first_tok is not None \
                    and req.t_last_tok is not None:
                self._tm.tpot.observe(
                    (req.t_last_tok - req.t_first_tok)
                    / (len(req.tokens) - 1))
        if req.trace is not None:
            t_join = req.t_join if req.t_join is not None else t1

            def build(tc, _req=req, _t_join=t_join, _t1=t1,
                      _reason=reason):
                tc.add("queue-wait", tc.root.t0, _t_join, "serve")
                tc.add("decode", _t_join, _t1, "serve",
                       meta={"steps": _req.n_steps,
                             "tokens": len(_req.tokens),
                             "prompt_len": len(_req.prompt),
                             "finish_reason": _reason})
            req.trace.finish(t1, build=build)

    # ------------------------------------------------------------ observe
    def _on_scheduler(self, fn):
        """Run ``fn`` on the scheduler thread (between steps) and return
        its result; inline when the scheduler is not running."""
        w = self._worker
        if w is None or not w.is_alive() \
                or w is threading.current_thread():
            return fn()
        fut = Future()
        self._tasks.append((fn, fut))
        self._adm.wake()
        while True:
            try:
                return fut.result(timeout=0.1)
            except FutureTimeout:
                if not w.is_alive():    # it exited before taking the task
                    self._run_tasks()

    def warmup(self):
        """Run the step program twice over a scratch pool, on the
        scheduler thread, so live traffic finds every kernel built and
        every library handle made.  Returns the number of step programs
        built (one per engine; churn builds none)."""
        return self._on_scheduler(self._warm)

    def _warm(self):
        z = np.zeros((self.num_slots,), np.float32)
        rep = self._rep
        prog = rep.program
        states = prog.zero_row(prog.init_states(), 0)
        for _ in range(2):
            if self._spec_k:
                _t, _c, states = prog.step_spec(z, z, z, z, states)
            else:
                _s, states = prog.step(z, z, z, states)
        # the whole (prompt bucket x batch bucket) prefill grid: every
        # shape live joiners can meet
        for b in rep.prefill_buckets:
            for bb in self._prefill_batches:
                rep.prefill_caches[b].run(
                    {self._prefill_data_name: np.zeros((bb, b), np.float32),
                     self._prefill_len_name: np.zeros((bb,), np.float32)},
                    host=False)
        if self._ctx.device.type == "cuda":
            torch.cuda.synchronize(self._ctx.device)
        return self.programs_built

    @property
    def programs_built(self):
        """Graph functions the engine built: the step program's (step,
        draft, commit), all at construction, plus one per prefill bucket
        signature dispatched.  The JAX package counts XLA traces here; a
        test pins that churn after warmup builds none."""
        n = self._rep.program.build_count
        for cache in {id(c): c
                      for c in self._rep.prefill_caches.values()}.values():
            n += cache.compile_count
        return n

    def _spec_stats(self):
        """The ``stats()["decode"]["spec"]`` block — caller holds
        ``self._lock``.  ``accept_rate`` is accepted/drafted;
        ``tokens_per_step`` counts committed tokens per slot per
        speculative step (1.0 floor, k+1 ceiling)."""
        if not self._spec_k:
            return {"enabled": False, "k": 0}
        drafted = self._spec_drafted
        return {
            "enabled": True,
            "k": self._spec_k,
            "steps": self._spec_steps,
            "drafted": drafted,
            "accepted": self._spec_accepted,
            "rejected": drafted - self._spec_accepted,
            "accept_rate": (self._spec_accepted / float(drafted)
                            if drafted else None),
            "tokens_per_step": ((self._spec_accepted
                                 + self._spec_slot_steps)
                                / float(self._spec_slot_steps)
                                if self._spec_slot_steps else None),
            "commit_selection": self._spec_cfg.selection,
            "commit_accepted": (bool(self._spec_cfg.commit_plan.accepted)
                                if self._spec_cfg.commit_plan is not None
                                else None),
        }

    def stats(self):
        """Admission counters plus the ``decode`` block: slot-pool
        geometry and occupancy, step/token/join/leave/eviction counts,
        the memory plan, the prefill grid and its dispatches, the
        selection and its gate, and per-step and end-to-end latency
        percentiles (ms)."""
        snap = self._adm.stats()
        plan = self.opt_plan
        mem = _memory_stats_block(self.memory_plan, self._ctx)
        with self._lock:
            step = sorted(self._step_ms)
            lat = sorted(self._lat_ms)
            snap["decode"] = {
                "slots": self.num_slots,
                "slots_occupied": len(self._rep.occupied()),
                "max_len": self.max_len,
                "device": str(self._ctx.device),
                "steps": self._steps,
                "tokens_generated": self._tokens_out,
                "joins": self._joins,
                "leaves": self._leaves,
                "evictions": self._evictions,
                "requests_served": self._requests_served,
                "programs_built": self.programs_built,
                "sampler": self._sampler.describe(),
                "memory": mem,
                "prefill": "bucket" if self._rep.prefill_caches else "step",
                "prefill_buckets": list(self._rep.prefill_buckets),
                "prefill_coalesced": self._coalesce,
                "prefill_batch_buckets": list(self._prefill_batches),
                "prefill_dispatches": self._prefill_dispatches,
                "analysis": {
                    "step_verdict": self.step_verdict,
                    "draft_verdict": self.draft_verdict,
                },
                "optimizer": {
                    "accepted": (bool(plan.accepted) if plan is not None
                                 else None),
                    "rewrites": (len(plan.rewrites) if plan is not None
                                 and plan.accepted else 0),
                    "reason": plan.reason if plan is not None else None,
                    "selection": self.selection,
                    "gate": plan.gate if plan is not None else None,
                },
                "spec": self._spec_stats(),
                "efficiency": (self._eff.stats_block()
                               if self._eff is not None
                               else {"enabled": False}),
                "step_ms": {
                    "count": len(step),
                    "mean": float(np.mean(step)) if step else 0.0,
                    "p50": _percentile(step, 0.50),
                    "p99": _percentile(step, 0.99),
                },
                "latency_ms": {
                    "count": len(lat),
                    "mean": float(np.mean(lat)) if lat else 0.0,
                    "p50": _percentile(lat, 0.50),
                    "p99": _percentile(lat, 0.99),
                },
            }
        return snap
