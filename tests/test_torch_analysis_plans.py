"""The port's analysis plans — FLOP counts, memory plans, repair plans and
optimizer plans — against the JAX package's, on the CPU.

The same graphs (``tests/test_optimize.py``'s, ``tests/test_rewrite.py``'s,
``tests/test_memory.py``'s and the model zoo's) are built through both
packages' Symbol APIs.  FLOP counts and memory plans are plain
arithmetic on shapes, so they are held equal field for field; repair and
optimizer plans are held equal as actions and as the JSON of the graph
they give.  Every optimized graph then runs in the port bit for bit as
its unoptimized graph does, and within rtol 1e-5, atol 1e-6 of the JAX
package's f32 run of it.  The one check across two different counters:
``count_flops`` within 10% of ``torch.utils.flop_counter.FlopCounterMode``
over the port's eager step of a plain ResNet-18 (the JAX package holds
its count against XLA's ``cost_analysis`` at the same bar).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import mxnet_tpu as mj
import mxnet_tpu.models.lenet as j_lenet
import mxnet_tpu.models.resnet as j_resnet
from mxnet_tpu import analysis as ja
from mxnet_tpu.analysis import optimize as j_opt
from mxnet_tpu.ops import registry as j_reg
from mxnet_tpu.serving import BucketPolicy as JPolicy
from mxnet_tpu.serving import spec as j_spec
from mxnet_tpu.symbol import symbol as j_symmod
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as ta
from mxnet_tpu_torch.analysis import optimize as t_opt
from mxnet_tpu_torch.ops import registry as t_reg
from mxnet_tpu_torch.serving import BucketPolicy as TPolicy
from mxnet_tpu_torch.serving import spec as t_spec
from mxnet_tpu_torch.symbol import symbol as t_symmod

from test_torch_analysis import _SeqPolicy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Pkg(object):
    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(mx=mj, an=ja, opt=j_opt, reg=j_reg, symmod=j_symmod,
         spec=j_spec, policy=JPolicy, get_mlp=j_lenet.get_mlp,
         get_lenet=j_lenet.get_lenet,
         get_resnet_symbol=j_resnet.get_resnet_symbol)
T = _Pkg(mx=mt, an=ta, opt=t_opt, reg=t_reg, symmod=t_symmod,
         spec=t_spec, policy=TPolicy, get_mlp=mt.models.get_mlp,
         get_lenet=mt.models.get_lenet,
         get_resnet_symbol=mt.models.get_resnet_symbol)


def _seq_policy(p, **kw):
    return JPolicy(**kw) if p is J else _SeqPolicy(**kw)


def _on_cpu(p):
    """The port's optimizer folds on the card unless told the CPU."""
    return {"device": "cpu"} if p is T else {}


def _build(p, fn):
    with p.mx.base.NameManager():
        return fn(p)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def decoder():
    """The attention decoder of the decode phase at a small size: the
    JAX package's graph, its JSON loaded by the port, numpy params."""
    bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                               "decode_bench.py"))
    with mj.base.NameManager():
        jt, t_info, _jd, _d_info, params = bench.build_spec_models(
            vocab=32, d=16, max_len=32, layers=2, seed=0)
    shapes = {"token": (4,), "pos": (4,)}
    shapes.update({s["name"]: (4,) + tuple(s["shape"]) for s in t_info})
    return dict(j=jt, t=mt.sym.load_json(jt.tojson()), info=t_info,
                shapes=shapes,
                params={k: np.array(v.asnumpy()) for k, v in params.items()})


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _redundant(p):
    """test_optimize.py's acceptance graph: duplicated subexpressions, a
    dead-after-rewrite branch, a constant subgraph, scalar identities."""
    mx = p.mx
    d = mx.sym.Variable("data")
    a2 = mx.sym.tanh(mx.sym.exp(d, name="a1"), name="a2")
    b2 = mx.sym.tanh(mx.sym.exp(d, name="b1"), name="b2")
    s = (a2 + b2) + mx.sym.zeros((4,))
    c = (mx.sym.ones((4,)) * 2.0) + mx.sym.ones((4,))
    return (s * 1.0) + c


FLOP_GRAPHS = {
    "mlp": (lambda p: p.get_mlp(), {"data": (8, 784)}),
    "lenet": (lambda p: p.get_lenet(), {"data": (8, 1, 28, 28)}),
    "resnet18": (lambda p: p.get_resnet_symbol(
        num_classes=10, num_layers=18, image_shape=(3, 32, 32)),
        {"data": (2, 3, 32, 32)}),
    # the fused units fall to the default rule in both packages
    "resnet50_fused": (lambda p: p.get_resnet_symbol(
        num_classes=10, num_layers=50, image_shape=(3, 32, 32),
        layout="NHWC", unit_impl="fused"), {"data": (2, 32, 32, 3)}),
    "redundant": (_redundant, {"data": (8, 4)}),
}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", sorted(FLOP_GRAPHS))
def test_count_flops_matches_reference(name, training):
    fn, shapes = FLOP_GRAPHS[name]
    j = ja.count_flops(_build(J, fn), shapes, training=training)
    t = ta.count_flops(_build(T, fn), shapes, training=training)
    assert t == j


def test_count_flops_decode_step_matches_reference(decoder):
    """The step graph before and after the gated selection: the scatter
    is priced as the row elements written in both packages."""
    for sel in (False, True):
        syms = {}
        for p in (J, T):
            g = decoder["j" if p is J else "t"]
            if sel:
                g = _gated(p, g, decoder).symbol
            syms[p] = g
        assert ta.count_flops(syms[T], decoder["shapes"]) == \
            ja.count_flops(syms[J], decoder["shapes"])


def test_count_flops_within_10pct_of_flop_counter_mode():
    """count_flops of a plain ResNet-18 training step (batch 2, 32x32)
    against FlopCounterMode over the port's eager forward and backward.
    The analytic count also prices BatchNorm, activations and pooling,
    which FlopCounterMode does not see; conv0's data gradient is left
    out of both (the data takes no gradient)."""
    sym = mt.models.get_resnet_symbol(num_classes=10, num_layers=18,
                                      image_shape=(3, 32, 32))
    shapes = {"data": (2, 3, 32, 32), "softmax_label": (2,)}
    want = ta.count_flops(sym, shapes, training=True)
    assert want["modeled_fraction"] > 0.95
    args, aux = mt.convert.random_params(sym, shapes, seed=3)
    targs, taux = mt.convert.params_from_numpy(args, aux, device=mt.cpu())
    req = {n: ("null" if n in shapes else "write")
           for n in sym.list_arguments()}
    exe = sym.simple_bind(mt.cpu(), grad_req=req, **shapes)
    for k, v in targs.items():
        v.copyto(exe.arg_dict[k])
    for k, v in taux.items():
        v.copyto(exe.aux_dict[k])
    x = np.random.default_rng(4).standard_normal(shapes["data"])
    mt.nd.array(x.astype(np.float32), ctx=mt.cpu()).copyto(
        exe.arg_dict["data"])
    mt.nd.array(np.array([1.0, 7.0], np.float32), ctx=mt.cpu()).copyto(
        exe.arg_dict["softmax_label"])
    with FlopCounterMode(display=False) as counter:
        exe.forward(is_train=True)
        exe.backward()
    got = counter.get_total_flops()
    assert abs(want["total"] - got) / got < 0.10, (want["total"], got)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def _hand(p):
    net = p.mx.sym.FullyConnected(p.mx.sym.Variable("data"),
                                  num_hidden=16, name="fc1")
    return p.mx.sym.Activation(net, act_type="relu", name="relu1")


MEMORY_GRAPHS = dict(FLOP_GRAPHS, hand=(_hand, {"data": (4, 8)}),
                     reshape=(lambda p: p.mx.sym.Reshape(
                         p.mx.sym.Variable("x"), shape=(8, 4), name="rs"),
                         {"x": (4, 8)}))


@pytest.mark.parametrize("name", sorted(MEMORY_GRAPHS))
def test_plan_memory_matches_reference(name):
    fn, shapes = MEMORY_GRAPHS[name]
    jplan, jrep = ja.plan_memory(_build(J, fn), shapes)
    tplan, trep = ta.plan_memory(_build(T, fn), shapes)
    assert tplan == jplan
    assert ta.predict_peak_bytes(_build(T, fn), shapes) == \
        ja.predict_peak_bytes(_build(J, fn), shapes) == jplan["peak_bytes"]
    assert [d.message for d in trep.by_pass("memory")] == \
        [d.message for d in jrep.by_pass("memory")]
    if name == "hand":
        assert tplan["peak_bytes"] == 1216


def _sum_step(p, sound=True, donate_token=False):
    mx = p.mx
    tok, s = mx.sym.Variable("token"), mx.sym.Variable("s")
    emb = mx.sym.Embedding(tok, input_dim=16, output_dim=8, name="emb")
    s2 = s + emb
    logits = mx.sym.FullyConnected(s2 if sound else s, num_hidden=16,
                                   name="out_fc")
    return mx.sym.Group([logits, s2])


@pytest.mark.parametrize("case,donate", [
    ("sound", {"s": 1}), ("unsound", {"s": 1}), ("mismatch", {"token": 1}),
    ("missing", {"nope": 1}), ("out_of_range", {"s": 5})])
def test_check_donation_matches_reference(case, donate):
    sound = case != "unsound"
    shapes = {"token": (4,), "s": (4, 8)}
    j = ja.check_donation(_build(J, lambda p: _sum_step(p, sound)),
                          shapes, donate)
    t = ta.check_donation(_build(T, lambda p: _sum_step(p, sound)),
                          shapes, donate)
    assert t.to_dict() == j.to_dict()
    assert t.accepted == (case == "sound")
    if case == "unsound":
        assert t.per_input["s"]["node"] == "out_fc"


def test_plan_memory_refuses_a_sharding_plan():
    with pytest.raises(mt.base.MXNetError, match="Queue A, item 7"):
        ta.plan_memory(_build(T, _hand), {"data": (4, 8)},
                       sharding={"axes": {"dp": 2}})


def test_device_memory_budget_on_the_cpu():
    assert ta.device_memory_budget(mt.cpu()) is None
    assert ta.device_memory_budget(torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# repair plans (tests/test_rewrite.py's graphs)
# ---------------------------------------------------------------------------

def _repair_softmax(p):
    net = p.mx.sym.softmax(p.mx.sym.Variable("data"), axis=1,
                           name="sm_seq")
    return p.an.repair_serving_graph(
        net, {"data": (4, 3)},
        _seq_policy(p, max_batch=2, seq_axis=0, seq_buckets=(4,)))


def _repair_reverse(p):
    net = p.mx.sym.reverse(p.mx.sym.Variable("data"), axis=1, name="rev")
    return p.an.repair_serving_graph(
        net, {"data": (4, 3)},
        _seq_policy(p, max_batch=2, seq_axis=0, seq_buckets=(4,)))


def _repair_no_seq(p):
    net = p.mx.sym.softmax(p.mx.sym.Variable("data"), axis=1)
    return p.an.repair_serving_graph(net, {"data": (4, 3)},
                                     p.policy(max_batch=2))


def _repair_batch_sum(p):
    d = p.mx.sym.Variable("data")
    pooled = p.mx.sym.sum(d, axis=0, keepdims=True, name="bsum")
    net = p.mx.sym.softmax(pooled, axis=1, name="sm")
    return p.an.plan_repair(net, {"data": (2, 4, 3)},
                            {"batch": {"data": 0}, "seq": {"data": 1}},
                            label="seq")


def _repair_mean(p):
    net = p.mx.sym.mean(p.mx.sym.Variable("data"), axis=1, name="pool")
    return p.an.repair_serving_graph(
        net, {"data": (4, 3)},
        _seq_policy(p, max_batch=2, seq_axis=0, seq_buckets=(4,)))


def _repair_inf_contraction(p):
    mx = p.mx
    data = mx.sym.Variable("data")
    vl = mx.sym.var("_pad_valid_len_seq", __pad_valid_len__="seq",
                    dtype="float32")
    kt = mx.sym.transpose(data, axes=(0, 2, 1))
    scores = mx.sym.batch_dot(data, kt, name="scores")
    masked = mx.sym.SequenceMask(scores, vl, use_sequence_length=True,
                                 value=float("-inf"), axis=2, name="msk")
    net = mx.sym.batch_dot(masked, data, name="attn")
    return p.an.plan_repair(
        net, {"data": (2, 4, 3), "_pad_valid_len_seq": (2,)},
        {"batch": {"data": 0, "_pad_valid_len_seq": 0},
         "seq": {"data": 1}}, label="seq")


REPAIRS = {"softmax_seq": (_repair_softmax, True),
           "reverse_seq": (_repair_reverse, False),
           "no_seq_buckets": (_repair_no_seq, False),
           "batch_sum_splice": (_repair_batch_sum, False),
           "mean_renorm": (_repair_mean, True),
           "inf_contraction": (_repair_inf_contraction, True)}


@pytest.mark.parametrize("name", sorted(REPAIRS))
def test_repair_plan_matches_reference(name):
    fn, accepted = REPAIRS[name]
    j, t = _build(J, fn), _build(T, fn)
    assert t.accepted == j.accepted == accepted, (t.reason, j.reason)
    assert t.reason == j.reason
    assert [tuple(a) for a in t.actions] == [tuple(a) for a in j.actions]
    assert (t.valid_length_name, t.length_sources, t.verdict_before,
            t.verdict_after) == (j.valid_length_name, j.length_sources,
                                 j.verdict_before, j.verdict_after)
    assert t.describe() == j.describe()
    if accepted:
        assert t.symbol.tojson() == j.symbol.tojson()


def test_repaired_mean_counts_live_rows_in_the_port():
    """The repaired mean divides by the live count: its live row equals
    the mean over the request's own rows."""
    plan = _build(T, _repair_mean)
    x = np.random.default_rng(3).standard_normal((3, 3)).astype(np.float32)
    feed = np.zeros((2, 4, 3), np.float32)
    feed[0, :3] = x
    out = _run_port(plan.symbol, {"data": feed,
                                  plan.valid_length_name:
                                  np.array([3.0, 0.0], np.float32)})[0]
    np.testing.assert_allclose(out[0], x.mean(axis=0), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizer plans (tests/test_optimize.py's graphs and the decoder's)
# ---------------------------------------------------------------------------

def _cse(p):
    mx = p.mx
    d = mx.sym.Variable("data")
    ab = mx.sym.exp(d, name="x1") + mx.sym.sqrt(d, name="y1")
    ba = mx.sym.sqrt(d, name="y2") + mx.sym.exp(d, name="x2")
    return mx.sym.Group([ab, ba])


def _dropouts(p):
    d = p.mx.sym.Variable("data")
    return p.mx.sym.Group([p.mx.sym.Dropout(d, p=0.5, name="do1"),
                           p.mx.sym.Dropout(d, p=0.5, name="do2")])


def _fold(p):
    mx = p.mx
    const = mx.sym.exp(mx.sym.ones((3,)) * 0.5) + mx.sym.zeros((3,))
    return mx.sym.Variable("data") + const


def _algebraic(p):
    mx = p.mx
    d = mx.sym.Variable("data")
    t = mx.sym.transpose(mx.sym.transpose(d, axes=(0, 2, 1)),
                         axes=(0, 2, 1))
    r = mx.sym.Reshape(mx.sym.Reshape(t, shape=(2, 12)), shape=(2, 3, 4))
    return mx.sym.Cast(r, dtype="float32") + mx.sym.zeros((3, 4))


def _chains(p):
    mx = p.mx
    d = mx.sym.Variable("data")
    return mx.sym.FullyConnected(
        mx.sym.tanh(mx.sym.exp(d * 2.0, name="e"), name="t"),
        num_hidden=4, name="fc")


def _unverified(p):
    bad = p.mx.sym.FullyConnected(p.mx.sym.Variable("data"), num_hidden=4,
                                  name="fc")
    bad._outputs[0][0].inputs.append(
        (p.symmod.SymNode(None, "extra", {}, []), 0))
    return bad


OPT_GRAPHS = {
    "cse": (_cse, {"data": (2, 3)}, {}),
    "dropout_training": (_dropouts, {"data": (2, 3)}, {"training": True}),
    "fold": (_fold, {"data": (2, 3)}, {}),
    "mul_by_zero": (lambda p: p.mx.sym.Variable("data") * 0.0,
                    {"data": (2,)}, {}),
    "algebraic": (_algebraic, {"data": (2, 3, 4)},
                  {"dtypes": {"data": np.float32}}),
    "widening_zero": (lambda p: p.mx.sym.Variable("w")
                      + p.mx.sym.zeros((2, 3)), {"w": (1, 3)}, {}),
    "redundant": (_redundant, {"data": (2, 4)}, {}),
    "row_local": (lambda p: p.mx.sym.relu(p.mx.sym.Variable("data"),
                                          name="r1")
                  + p.mx.sym.relu(p.mx.sym.Variable("data"), name="r2"),
                  {"data": (2, 4, 3)},
                  {"pad_axes": {"batch": {"data": 0},
                                "seq": {"data": 1}}}),
    "chains": (_chains, {"data": (2, 3)}, {}),
    "unverified": (_unverified, {"data": (2, 3)}, {}),
}


def _plan_key(plan):
    return dict(accepted=plan.accepted, reason=plan.reason,
                actions=[tuple(a) for a in plan.actions],
                per_pass=dict(plan.per_pass),
                nodes=(plan.nodes_before, plan.nodes_after),
                verdicts=(plan.verdicts_before, plan.verdicts_after),
                flops=plan.flops_delta(),
                json=plan.symbol.tojson() if plan.symbol is not None
                else None)


def _rand_feeds(sym, shapes, seed):
    arg_shapes = dict(zip(sym.list_arguments(),
                          sym.infer_shape(**shapes)[0]))
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sorted(arg_shapes.items())}


def _run_port(sym, feeds):
    args = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in feeds.items()}
    exe = sym.bind(mt.cpu(), args=args, grad_req="null")
    return [o.asnumpy() for o in exe.forward(is_train=False)]


def _run_jax(sym, feeds):
    return [np.asarray(o.asnumpy()) for o in sym.eval(
        ctx=mj.cpu(), **{k: mj.nd.array(v) for k, v in feeds.items()})]


def _assert_runs_match(tsym, topt, jopt, feeds, scaled=None):
    """Port optimized == port unoptimized, bit for bit; against the JAX
    package's f32 run at rtol 1e-5, atol 1e-6, or, with ``scaled``, at
    ``scaled`` times each output's largest magnitude (the decoder: its
    two packages sum the attention step in another order, as
    tests/test_torch_decode.py states)."""
    base = _run_port(tsym, feeds)
    got = _run_port(topt, feeds)
    ref = _run_jax(jopt, feeds)
    for b, g, r in zip(base, got, ref):
        np.testing.assert_array_equal(g, b)
        if scaled is None:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(
                g, r, rtol=0, atol=scaled * float(np.abs(r).max()))


@pytest.mark.parametrize("passes", ["default", "select"])
@pytest.mark.parametrize("name", sorted(OPT_GRAPHS))
def test_optimize_graph_matches_reference(name, passes):
    fn, shapes, kw = OPT_GRAPHS[name]
    plans, syms = {}, {}
    for p in (J, T):
        syms[p] = _build(p, fn)
        names = (p.an.DEFAULT_OPT_PASSES if passes == "default"
                 else p.an.SELECT_OPT_PASSES)
        plans[p] = p.an.optimize_graph(syms[p], data_shapes=shapes,
                                       passes=names, **kw, **_on_cpu(p))
    assert _plan_key(plans[T]) == _plan_key(plans[J])
    tp = plans[T]
    if tp.accepted and tp.symbol is not None:
        _assert_runs_match(syms[T], tp.symbol, plans[J].symbol,
                           _rand_feeds(syms[T], shapes, seed=7))
    if name == "mul_by_zero":
        nan = _run_port(tp.symbol, {"data": np.array([np.nan, 1.0],
                                                     np.float32)})[0]
        assert np.isnan(nan[0]) and nan[1] == 0.0


def _gated(p, symbol, dec, passes=None):
    shapes = dec["shapes"]
    return p.an.optimize_graph(
        symbol, data_shapes=shapes,
        pad_axes={"slot": {n: 0 for n in shapes}},
        pad_dirty=tuple(s["name"] for s in dec["info"]),
        passes=passes or p.an.SELECT_OPT_PASSES, **_on_cpu(p))


def _decode_feeds(dec, seed):
    rng = np.random.default_rng(seed)
    feeds = {"token": rng.integers(0, 32, 4).astype(np.float32),
             "pos": np.array([0, 5, 17, 31], np.float32)}
    for s in dec["info"]:
        feeds[s["name"]] = (rng.standard_normal((4,) + tuple(s["shape"]))
                            * 0.5).astype(np.float32)
    feeds.update(dec["params"])
    return feeds


@pytest.mark.parametrize("passes", ["default", "select"])
def test_optimize_decode_step_matches_reference(decoder, passes):
    """The decode engine's gated pipeline over the step graph: the
    selections, the folds of the causal mask's constant and the sweeps,
    equal to the JAX package's; the slot axis stays row-local."""
    plans = {p: _gated(p, decoder["j" if p is J else "t"], decoder,
                       passes=(p.an.DEFAULT_OPT_PASSES
                               if passes == "default" else None))
             for p in (J, T)}
    assert _plan_key(plans[T]) == _plan_key(plans[J])
    tp = plans[T]
    assert tp.accepted and tp.verdicts_after == {"slot": "row-local"}
    assert (passes == "select") == any(a.kind == "select"
                                       for a in tp.actions)
    _assert_runs_match(decoder["t"], tp.symbol, plans[J].symbol,
                       _decode_feeds(decoder, seed=9), scaled=2e-5)


@pytest.mark.parametrize("K", [3])
def test_optimize_commit_chain_matches_reference(decoder, K):
    out = {}
    for p in (J, T):
        specs = [(s["name"], (4,) + tuple(s["shape"]), np.float32)
                 for s in decoder["info"]]
        with p.mx.base.NameManager():
            commit, shapes, cn, rn = p.spec.build_commit_sym(specs, K)
        out[p] = (commit, shapes) + p.spec.select_commit(
            commit, shapes, cn, rn, **_on_cpu(p))
    (jc, jsh, jserved, jsel, jplan), (tc, tsh, tserved, tsel, tplan) = \
        out[J], out[T]
    assert tsh == jsh and tsel == jsel and len(tsel) == len(
        decoder["info"])
    assert _plan_key(tplan) == _plan_key(jplan)
    rng = np.random.default_rng(11)
    feeds = {k: (rng.integers(0, 32 - K, s[0]).astype(np.float32)
                 if k.endswith("pos__") else
                 rng.integers(0, K + 1, s[0]).astype(np.float32)
                 if k.endswith("count__") else
                 rng.standard_normal(s).astype(np.float32))
             for k, s in tsh.items()}
    _assert_runs_match(tc, tserved, jserved, feeds)


def _evil_cast(p):
    def evil(state):
        head, ix = state.symbol._outputs[0]
        if head.name == "evil_cast":
            return 0
        op = p.reg.get_op("Cast")
        node = p.symmod.SymNode(op, "evil_cast",
                                op.normalize({"dtype": "float16"}),
                                [(head, ix)])
        state.track(node)
        state.symbol._outputs[0] = (node, 0)
        state.record("evil", "fold", node, "downcast the output")
        return 1
    return evil, {"data_shapes": {"data": (2, 3)},
                  "dtypes": {"data": np.float32}}


def _evil_softmax(p):
    def evil(state):
        head, ix = state.symbol._outputs[0]
        if head.name == "evil_sm":
            return 0
        op = p.reg.get_op("softmax")
        node = p.symmod.SymNode(op, "evil_sm", op.normalize({"axis": 1}),
                                [(head, ix)])
        state.track(node)
        state.symbol._outputs[0] = (node, 0)
        state.record("evil", "rewrite", node, "softmax over the seq axis")
        return 1
    return evil, {"data_shapes": {"data": (2, 4, 3)},
                  "pad_axes": {"batch": {"data": 0}, "seq": {"data": 1}}}


@pytest.mark.parametrize("make,word", [(_evil_cast, "dtype"),
                                       (_evil_softmax, "verdict")])
def test_verdict_worsening_candidate_rejected_as_reference(make, word):
    plans = {}
    for p in (J, T):
        evil, kw = make(p)
        net = _build(p, lambda q: q.mx.sym.relu(q.mx.sym.Variable("data"),
                                                name="r"))
        p.opt.OPT_PASSES["evil"] = evil
        try:
            plans[p] = p.an.optimize_graph(net, passes=("evil", "dce"),
                                           **kw, **_on_cpu(p))
        finally:
            del p.opt.OPT_PASSES["evil"]
    assert _plan_key(plans[T]) == _plan_key(plans[J])
    assert not plans[T].accepted and word in plans[T].reason
    assert plans[T].gate == t_opt.GATE


def test_fold_evaluates_on_the_given_device():
    """The fold runs the constant subgraph where the graph will run:
    the baked bits are what the executor computes there."""
    net = _build(T, _fold)
    plan = ta.optimize_graph(net, data_shapes={"data": (2, 3)},
                             device=torch.device("cpu"))
    assert [a.kind for a in plan.rewrites] == ["rewrite", "fold"]
    baked = next(n for n in t_symmod._topo(plan.symbol._outputs)
                 if n.op is not None and n.op.name == "_constant")
    want = torch.exp(torch.ones(3) * 0.5) + torch.zeros(3)
    assert np.array_equal(np.asarray(baked.attrs["value"], np.float32),
                          want.numpy())


def test_fold_device_defaults_to_the_current_context():
    """With no ``device`` the optimizer folds where the port's entry
    points run: the first card, raising when there is none, or the CPU
    inside a ``with cpu():`` scope."""
    net = _build(T, _fold)
    with mt.cpu():
        plan = ta.optimize_graph(net, data_shapes={"data": (2, 3)})
    assert [a.kind for a in plan.rewrites] == ["rewrite", "fold"]
    if not torch.cuda.is_available():
        with pytest.raises(mt.base.MXNetError, match="no CUDA device"):
            ta.optimize_graph(net, data_shapes={"data": (2, 3)})
