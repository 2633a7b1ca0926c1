"""Stochastic sampling in the PyTorch port's decode engine, on the CPU,
against the JAX package.

JAX draws its noise with threefry and ``fold_in``, torch with its own
generator, so the two packages cannot be compared by their own draws.
Parity is held by injecting the JAX package's noise: the tests compute
``jax.random.gumbel`` / ``jax.random.uniform`` at the keys the JAX
package's schedule folds in (proposal j at ``2j``, accept uniform j at
``2j+1``, the position-i fallback at ``2K+i``) and hand them to the
port's noise-taking functions.  ``TemperatureSampler`` draws and
``rejection_accept`` tokens and accept counts are then held exactly,
apart from rows whose uniform lies within 1e-6 of ``min(1, p/q)``, where
the two packages' softmax rounding may decide differently (counted, and
held to be few).  Within the port: ``top_k=1`` equals greedy, a seeded
engine replays bit for bit, and the emitted first token follows ``p``
(a chi-square test at significance 1e-4 over 20,000 rows).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import mxnet_tpu as mj
from mxnet_tpu.serving.decode import TemperatureSampler as JTemperature
from mxnet_tpu.serving.spec import rejection_accept as j_rejection_accept
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import (DecodeEngine, GreedySampler, Sampler,
                                     StepProgram, TemperatureSampler,
                                     greedy_decode)
from mxnet_tpu_torch.serving.decode import categorical, gumbel
from mxnet_tpu_torch.serving.spec import rejection_accept

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=32, d=16, max_len=32, layers=2, tail_scale=0.05)
SLOTS = 4
NEAR = 1e-6


def _logits(rng, n, v, ties=True):
    z = rng.standard_normal((n, v)).astype(np.float32) * 2.0
    if ties:            # tied logits straddling the k-th place
        z[:, 3] = z[:, 5] = z[:, 7]
    return z


def test_spec_logits_and_gumbel_draw_match_jax():
    """Temperature and the top-k mask (the k-th-value rule: ties with the
    k-th logit survive) bitwise against the JAX sampler's; with the JAX
    package's Gumbel noise injected, ``sample`` draws exactly what
    ``jax.random.categorical`` draws at the same key."""
    rng = np.random.default_rng(0)
    z = _logits(rng, 64, 40)
    key = jax.random.PRNGKey(3)
    for temp, top_k in ((0.8, 5), (1.3, None), (0.5, 1), (1.0, 40)):
        ours, theirs = TemperatureSampler(temp, top_k), JTemperature(temp,
                                                                     top_k)
        got = ours.spec_logits(torch.from_numpy(z)).numpy()
        want = np.asarray(theirs.spec_logits(jnp.asarray(z)))
        np.testing.assert_array_equal(got, want)
        for i in range(3):
            k = jax.random.fold_in(key, i)
            noise = np.array(jax.random.gumbel(k, z.shape, jnp.float32))
            drawn = ours.sample(torch.from_numpy(z), torch.from_numpy(noise))
            np.testing.assert_array_equal(
                drawn.numpy(), np.asarray(theirs.sample(k, jnp.asarray(z))))
    # the clamp: u = 0 gives a finite draw, as jax's minval=tiny does
    g = gumbel(torch.tensor([0.0, 0.5, 1.0 - 2 ** -24]))
    assert bool(torch.isfinite(g).all())
    tiny = np.float32(np.finfo(np.float32).tiny)
    np.testing.assert_allclose(g[0].item(), -np.log(-np.log(tiny)),
                               rtol=1e-6)


@pytest.mark.parametrize("K", [3, 5])
def test_rejection_accept_matches_jax_with_injected_noise(K):
    """Tokens and accept counts of ``rejection_accept`` against the JAX
    package's at the same step key, the port fed the JAX noise by the
    fold-in schedule; draft proposals themselves are the JAX
    categorical draws at ``2j``."""
    rng = np.random.default_rng(K)
    n, v = 256, 12
    sampler = JTemperature(0.9, top_k=8)
    tl = [_logits(rng, n, v, ties=False) for _ in range(K)]
    # draft logits near the target's, so that many proposals pass
    dl = [t + rng.standard_normal((n, v)).astype(np.float32) * 0.7
          for t in tl]
    kstep = jax.random.fold_in(jax.random.PRNGKey(11), 7)
    xs = [rng.integers(0, v, n).astype(np.float32)]
    gum_prop, us = [], []
    for j in range(K - 1):
        kj = jax.random.fold_in(kstep, 2 * j)
        gum_prop.append(np.array(jax.random.gumbel(kj, (n, v),
                                                     jnp.float32)))
        xs.append(np.array(jax.random.categorical(
            kj, sampler.spec_logits(jnp.asarray(dl[j])), axis=-1)
        ).astype(np.float32))
        us.append(np.array(jax.random.uniform(
            jax.random.fold_in(kstep, 2 * j + 1), shape=(n,))))
    fall = [np.array(jax.random.gumbel(
        jax.random.fold_in(kstep, 2 * K + i), (n, v), jnp.float32))
        for i in range(K)]
    jt, ja = j_rejection_accept(kstep, [jnp.asarray(x) for x in xs],
                                [jnp.asarray(t) for t in tl],
                                [jnp.asarray(d) for d in dl],
                                sampler.spec_logits)
    ours = TemperatureSampler(0.9, top_k=8)
    T = torch.from_numpy
    # the port's proposal draw from the injected noise is JAX's
    for j in range(K - 1):
        prop = categorical(ours.spec_logits(T(dl[j])), T(gum_prop[j]))
        np.testing.assert_array_equal(prop.numpy().astype(np.float32),
                                      xs[j + 1])
    tt, ta = rejection_accept([T(x) for x in xs], [T(t) for t in tl],
                              [T(d) for d in dl], ours.spec_logits,
                              [T(u) for u in us], [T(f) for f in fall])
    # rows whose accept test sits at the rounding edge
    zt = [ours.spec_logits(T(t)) for t in tl]
    p = [torch.softmax(z, -1) for z in zt]
    q = [torch.softmax(ours.spec_logits(T(d)), -1) for d in dl[:K - 1]]
    near = np.zeros(n, bool)
    for j in range(K - 1):
        xi = torch.from_numpy(xs[j + 1]).long()[:, None]
        ratio = (p[j].gather(1, xi) / q[j].gather(1, xi))[:, 0].numpy()
        near |= np.abs(us[j] - np.minimum(ratio, 1.0)) < NEAR
    assert near.sum() <= 2
    keep = ~near
    np.testing.assert_array_equal(ta.numpy()[keep], np.asarray(ja)[keep])
    np.testing.assert_array_equal(tt.numpy()[keep], np.asarray(jt)[keep])
    # every path ran: full accepts, early rejections, first-place ones
    acc = ta.numpy()
    assert (acc == K - 1).any() and (acc == 0).any() \
        and ((acc > 0) & (acc < K - 1)).any()


def test_emitted_first_token_follows_p():
    """Rejection sampling emits tokens distributed as the target's
    sampler: 20,000 rows of one (p, q) pair with q != p at vocab 8, each
    with its own proposal and noise from a seeded generator; the first
    emitted token's counts against p under a chi-square test at
    significance 1e-4."""
    n, v = 20000, 8
    gen = torch.Generator().manual_seed(5)
    tz = torch.tensor([[2.0, 1.0, 0.5, 0.0, -0.5, 1.5, -1.0, 0.2]])
    dz = torch.tensor([[0.5, 2.0, 0.5, 1.0, -1.0, 0.0, 0.5, -0.5]])
    sampler = TemperatureSampler(1.0)
    tl = [tz.expand(n, v), tz.expand(n, v)]
    dl = [dz.expand(n, v)]

    def g(shape):
        return gumbel(torch.rand(shape, generator=gen))
    prop = categorical(sampler.spec_logits(dl[0]), g((n, v))).float()
    us = [torch.rand((n,), generator=gen)]
    toks, _a = rejection_accept([torch.zeros(n), prop], tl, dl,
                                sampler.spec_logits, us,
                                [g((n, v)), g((n, v))])
    counts = np.bincount(toks[:, 0].long().numpy(), minlength=v)
    p = torch.softmax(tz.double(), -1)[0].numpy()
    _chi2, pval = stats.chisquare(counts, p * n)
    assert pval > 1e-4, (counts, p * n, pval)
    q = torch.softmax(dz.double(), -1)[0].numpy()
    _chi2, qval = stats.chisquare(counts, q * n)
    assert qval < 1e-4          # the test tells p from q


def test_construction_refusals():
    class NoSpec(Sampler):
        def sample(self, logits, noise):
            return torch.argmax(logits, -1).to(logits.dtype)
    with pytest.raises(mt.base.MXNetError, match="temperature"):
        TemperatureSampler(0.0)
    with pytest.raises(mt.base.MXNetError, match="top_k"):
        TemperatureSampler(1.0, top_k=0)
    m = _models()
    with pytest.raises(mt.base.MXNetError, match="spec_logits"):
        _engine(m, k=2, sampler=NoSpec(), start=False)
    _engine(m, k=0, sampler=NoSpec(), start=False).close()


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MODELS = {}


def _models():
    if not _MODELS:
        bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                                   "decode_bench.py"))
        with mj.base.NameManager():
            jt, t_info, jd, d_info, jp = bench.build_spec_models(seed=0,
                                                                 **SMALL)
        load = lambda s: mt.sym.load_json(s.tojson())  # noqa: E731
        _MODELS.update(t=load(jt), d=load(jd), t_info=t_info,
                       d_info=d_info, params={
                           k: np.array(v.asnumpy()) for k, v in jp.items()})
    return _MODELS


def _engine(m, k=0, **kw):
    p = mt.convert.params_from_numpy(m["params"], {}, device=mt.cpu())[0]
    spec = {}
    if k:
        spec = dict(draft_sym=m["d"], spec_k=k, draft_arg_params=p,
                    draft_state_info=m["d_info"])
    return DecodeEngine(m["t"], p, {}, m["t_info"], num_slots=SLOTS,
                        max_len=SMALL["max_len"], ctx=mt.cpu(),
                        default_deadline_ms=0, **spec, **kw)


JOBS = [([1, 5, 9], 9), ([3], 12), ([7, 2], 6), ([4, 4, 4, 4], 10),
        ([11], 8), ([2, 30], 11)]


def _streams(eng):
    try:
        eng.warmup()
        futs = [eng.submit(p, max_new_tokens=n) for p, n in JOBS]
        return [list(f.result(timeout=120).tokens) for f in futs], \
            eng.stats()["decode"]
    finally:
        eng.close()


def test_top_k_1_equals_greedy():
    """``TemperatureSampler(..., top_k=1)`` at k = 0 and 2 gives exactly
    the greedy streams (``greedy_decode``'s): the mask leaves one finite
    logit whatever the noise."""
    m = _models()
    p = mt.convert.params_from_numpy(m["params"], {}, device=mt.cpu())[0]
    prog = StepProgram(m["t"], p, {}, m["t_info"], SLOTS, ctx=mt.cpu())
    want = [list(greedy_decode(prog, pr, n)) for pr, n in JOBS]
    for k in (0, 2):
        got, st = _streams(_engine(m, k=k, sampler=TemperatureSampler(
            0.7, top_k=1, seed=3)))
        assert got == want, k
        assert st["sampler"] == {"kind": "temperature", "temperature": 0.7,
                                 "top_k": 1, "seed": 3}


@pytest.mark.parametrize("k", [0, 2])
def test_seeded_replay_is_bitwise(k):
    """The same seed and the same submission history replay bit for bit
    in two engines; another seed draws another stream."""
    m = _models()
    runs = [_streams(_engine(m, k=k, sampler=TemperatureSampler(
        0.8, top_k=10, seed=s)))[0] for s in (21, 21, 22)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert [len(s) for s in runs[0]] == [n for _p, n in JOBS]


def test_temperature_step_probe_is_fixed():
    """``probe_step`` runs at tick 0 and leaves the tick alone, so two
    programs with one seed agree there, sampler and all."""
    m = _models()
    p = mt.convert.params_from_numpy(m["params"], {}, device=mt.cpu())[0]
    progs = [StepProgram(m["t"], p, {}, m["t_info"], SLOTS, ctx=mt.cpu(),
                         sampler=TemperatureSampler(1.0, seed=9))
             for _ in range(2)]
    z = np.zeros(SLOTS, np.float32)
    progs[0].step(z, z, z, progs[0].init_states())
    a, b = progs[0].probe_step(), progs[1].probe_step()
    assert progs[0]._tick == 1 and progs[1]._tick == 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert isinstance(GreedySampler().describe(), dict)
