"""The static-analysis core of the PyTorch port (``mxnet_tpu_torch/
analysis``: verifier, shapes, retrace, padding) against the JAX package's,
on the CPU.

Each graph of ``tests/test_analysis.py`` is built with the same code
through both packages' Symbol APIs and analyzed with ``DEFAULT_PASSES``
(or the entry point the JAX test drives) in both.  Held equal: the pad
verdicts, every diagnostic's ``(severity, pass_name, node, op)`` in
order, and its ``hazard_fingerprint``.  Messages are held equal too,
except where they name a mechanism of one backend; those are listed in
``BACKEND_MESSAGES`` with the reason.  The port's ``BucketPolicy`` has
no sequence axis, so the graphs that bucket one take ``_SeqPolicy``, a
stand-in with the JAX policy's attributes, on the port's side.
"""
import ast
import glob
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu.models.lenet as j_lenet
import mxnet_tpu.models.resnet as j_resnet
from mxnet_tpu import analysis as ja
from mxnet_tpu.analysis import retrace as j_retrace
from mxnet_tpu.ops import registry as j_reg
from mxnet_tpu.serving import BucketPolicy as JPolicy
from mxnet_tpu.symbol import symbol as j_symmod
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as ta
from mxnet_tpu_torch.analysis import retrace as t_retrace
from mxnet_tpu_torch.ops import registry as t_reg
from mxnet_tpu_torch.serving import BucketPolicy as TPolicy
from mxnet_tpu_torch.symbol import symbol as t_symmod

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (case, pass, node) whose message names one backend's mechanism.  The
#: text before the first ":" (and so the fingerprint) is still equal.
BACKEND_MESSAGES = {
    # the op's own shape error: jax.eval_shape's against torch's
    ("rank_mismatch", "shapes", "bad_dot"),
    ("shape_literal", "shapes", "rigid"),
    # "traces a new XLA program (CachedOp.trace_count ...)" against
    # "builds a new program (ProgramCache.compile_count ...)"
    ("retrace_unbucketed", "retrace", "data"),
    ("retrace_adjacent", "retrace", "data"),
    ("dynamic_dim_notes", "retrace", "data"),
    ("shape_literal", "retrace", "data"),
    # the JAX package's per-(op, attrs) jit cache against the port's
    # program key and symbol JSON
    ("cache_busting_attr", "retrace", "act"),
    # pure_callback against torch's host round trips
    ("host_sync", "retrace", "hostcall"),
}


class _Pkg(object):
    def __init__(self, mx, an, reg, symmod, policy_cls, get_lenet,
                 get_resnet_symbol):
        self.mx, self.an, self.reg, self.symmod = mx, an, reg, symmod
        self.policy_cls = policy_cls
        self.get_lenet = get_lenet
        self.get_resnet_symbol = get_resnet_symbol


J = _Pkg(mj, ja, j_reg, j_symmod, JPolicy, j_lenet.get_lenet,
         j_resnet.get_resnet_symbol)
T = _Pkg(mt, ta, t_reg, t_symmod, TPolicy, mt.models.get_lenet,
         mt.models.get_resnet_symbol)


class _SeqPolicy(object):
    """The JAX BucketPolicy's sequence-bucket attributes for the port's
    analysis (the port's policy has no sequence axis yet)."""

    def __init__(self, max_batch, seq_axis, seq_buckets):
        self.max_batch = max_batch
        self.seq_axis = seq_axis
        self.seq_buckets = tuple(seq_buckets)

    def batch_buckets(self):
        return TPolicy(self.max_batch).batch_buckets()

    def example_shape(self, ex):
        b = next(x for x in self.seq_buckets if x >= ex[self.seq_axis])
        return ex[:self.seq_axis] + (b,) + ex[self.seq_axis + 1:]


def _seq_policy(p, **kw):
    return JPolicy(**kw) if p is J else _SeqPolicy(**kw)


def _mlp(mx):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _register_once(p, name, impl, **kw):
    if name not in p.reg._REGISTRY:
        p.reg.register(name, **kw)(impl)


# ---------------------------------------------------------------------------
# the graphs of tests/test_analysis.py, one function per graph for both packages;
# each returns (verdicts, report)
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _default(p, net, shapes, **kw):
    report, ctx = p.an.analyze(net, data_shapes=shapes, **kw)
    return dict(ctx.pad_verdicts), report


@case
def mlp_clean(p):
    return _default(p, _mlp(p.mx), {"data": (4, 6)})


@case
def cycle(p):
    net = _mlp(p.mx)
    fc1 = next(n for n in p.an.GraphView(net).topo if n.name == "fc1")
    fc1.inputs[0] = (net._outputs[0][0], 0)
    return _default(p, net, {"data": (2, 4)})


@case
def duplicate_argument(p):
    net = p.mx.sym.Variable("x") + p.mx.sym.Variable("x")
    return _default(p, net, {"x": (2, 3)})


@case
def dangling_edge(p):
    net = p.mx.sym.Activation(p.mx.sym.Variable("data"), act_type="relu",
                              name="act")
    node = net._outputs[0][0]
    node.inputs[0] = (node.inputs[0][0], 3)
    return _default(p, net, {"data": (2, 3)})


@case
def arity_mismatch(p):
    net = p.mx.sym.Activation(p.mx.sym.Variable("data"), act_type="relu",
                              name="act")
    net._outputs[0][0].inputs.append(
        (p.mx.sym.Variable("extra")._outputs[0][0], 0))
    return _default(p, net, {"data": (2, 3)})


@case
def attr_schema(p):
    net = p.mx.sym.Activation(p.mx.sym.Variable("data"), act_type="relu",
                              name="act")
    net._outputs[0][0].attrs["act_type"] = "warp_drive"
    return _default(p, net, {"data": (2, 3)})


@case
def unregistered_op(p):
    rogue = p.reg.OpDef("not_a_real_op", lambda attrs, x: x)
    node = p.symmod.SymNode(
        rogue, "rogue0", {},
        [(p.mx.sym.Variable("data")._outputs[0][0], 0)])
    return _default(p, p.symmod.Symbol([(node, 0)]), {"data": (2, 3)})


@case
def rank_mismatch(p):
    x = p.mx.sym.Variable("data")
    c = p.mx.sym.Convolution(x, kernel=(3, 3), num_filter=4, name="conv0")
    f = p.mx.sym.FullyConnected(c, num_hidden=10, name="fc1")
    return _default(p, p.mx.sym.dot(f, f, name="bad_dot"),
                    {"data": (8, 3, 24, 24)})


@case
def blocked_node(p):
    return _default(p, _mlp(p.mx), {})


@case
def dynamic_dim_notes(p):
    return _default(p, _mlp(p.mx), {"data": (0, 6)})


@case
def retrace_unbucketed(p):
    return _default(p, _mlp(p.mx), {"data": (0, 6)},
                    passes=("verify", "shapes", "retrace"))


@case
def retrace_covered(p):
    pol = _seq_policy(p, max_batch=4, seq_axis=0, seq_buckets=(4, 8))
    net = p.mx.sym.Activation(p.mx.sym.Variable("data"), act_type="tanh")
    return _default(p, net, {"data": (2, 0, 3)}, policy=pol)


@case
def shape_literal(p):
    data = p.mx.sym.Variable("data")
    net = p.mx.sym.Group([p.mx.sym.Reshape(data, shape=(4, 6),
                                           name="rigid"),
                          p.mx.sym.Reshape(data, shape=(-1, 6),
                                           name="poly")])
    return _default(p, net, {"data": (0, 24)})


@case
def cache_busting_attr(p):
    net = p.mx.sym.Activation(p.mx.sym.Variable("data"), act_type="relu",
                              name="act")
    net._outputs[0][0].attrs["lookup"] = np.zeros((3,))
    return _default(p, net, {"data": (2, 3)}, passes=("verify", "retrace"))


def _j_host(attrs, x):
    import jax
    return jax.pure_callback(lambda a: a, jax.ShapeDtypeStruct(
        x.shape, x.dtype), x)


def _t_host(attrs, x):
    return x * float(x.sum().item() * 0.0 + 1.0)


@case
def host_sync(p):
    """An op whose impl reads device values back on the host: the JAX
    package's through ``pure_callback`` (what its Custom op runs; the
    port has no Custom op), the port's through ``.item()``."""
    _register_once(p, "_lint_host_probe",
                   _j_host if p is J else _t_host)
    net = p.symmod._create("_lint_host_probe", [p.mx.sym.Variable("data")],
                           {}, name="hostcall")
    return _default(p, net, {"data": (2, 3)}, passes=("verify", "retrace"))


@case
def padding_row_local_mlp(p):
    return p.an.check_serving_graph(_mlp(p.mx), {"data": (6,)},
                                    p.policy_cls(max_batch=4))


@case
def softmax_over_batch(p):
    net = p.mx.sym.softmax(p.mx.sym.Variable("data"), axis=0, name="sm0")
    return p.an.check_serving_graph(net, {"data": (6,)},
                                    p.policy_cls(max_batch=4))


def _seq_check(p, net):
    pol = _seq_policy(p, max_batch=2, seq_axis=0, seq_buckets=(4,))
    return p.an.check_serving_graph(net, {"data": (4, 3)}, pol)


@case
def seq_sum_absorbs(p):
    data = p.mx.sym.Variable("data")
    return _seq_check(p, p.mx.sym.Group([
        p.mx.sym.sum(data, axis=1, name="pool"),
        p.mx.sym.Activation(data, act_type="tanh")]))


@case
def seq_mean_mixes(p):
    return _seq_check(p, p.mx.sym.mean(p.mx.sym.Variable("data"), axis=1,
                                       name="avg"))


@case
def zero_chain_sigmoid(p):
    return _seq_check(p, p.mx.sym.sum(p.mx.sym.Activation(
        p.mx.sym.Variable("data"), act_type="sigmoid"), axis=1,
        name="pool"))


@case
def zero_chain_relu(p):
    return _seq_check(p, p.mx.sym.sum(p.mx.sym.Activation(
        p.mx.sym.Variable("data"), act_type="relu"), axis=1, name="pool"))


@case
def unknown_op(p):
    _register_once(p, "_lint_mystery_op", lambda attrs, x: x)
    net = p.symmod._create("_lint_mystery_op", [p.mx.sym.Variable("data")],
                           {}, name="mystery")
    return p.an.check_serving_graph(net, {"data": (6,)},
                                    p.policy_cls(max_batch=2))


@case
def batchnorm_inference(p):
    net = p.mx.sym.BatchNorm(p.mx.sym.Variable("data"), name="bn0")
    return p.an.check_serving_graph(net, {"data": (3, 5, 5)},
                                    p.policy_cls(max_batch=4))


@case
def batchnorm_training(p):
    net = p.mx.sym.BatchNorm(p.mx.sym.Variable("data"), name="bn0")
    return p.an.check_serving_graph(net, {"data": (3, 5, 5)},
                                    p.policy_cls(max_batch=4),
                                    training=True)


@case
def reorder(p):
    net = p.mx.sym.reverse(p.mx.sym.Variable("data"), axis=(0,),
                           name="flip")
    return p.an.check_serving_graph(net, {"data": (6,)},
                                    p.policy_cls(max_batch=4))


@case
def zoo_lenet(p):
    return p.an.check_serving_graph(p.get_lenet(),
                                    {"data": (1, 28, 28)},
                                    p.policy_cls(max_batch=4))


@case
def zoo_resnet18(p):
    net = p.get_resnet_symbol(num_classes=10, num_layers=18,
                                        image_shape=(3, 32, 32))
    return p.an.check_serving_graph(net, {"data": (3, 32, 32)},
                                    p.policy_cls(max_batch=4))


@case
def greater_scalar_negative(p):
    return _seq_check(p, p.mx.sym.sum(p.mx.sym.Variable("data") > -1.0,
                                      axis=1, name="pool"))


@case
def greater_scalar_positive(p):
    return _seq_check(p, p.mx.sym.sum(p.mx.sym.Variable("data") > 0.5,
                                      axis=1, name="pool"))


def _masked_sum(p, value):
    m = p.mx.sym.SequenceMask(p.mx.sym.Variable("data"),
                              p.mx.sym.Variable("slen"),
                              use_sequence_length=True, value=value,
                              axis=1, name="mask")
    return p.an.classify_padding(p.mx.sym.sum(m, axis=1, name="pool"),
                                 {"data": (2, 8, 3), "slen": (2,)},
                                 {"seq": {"data": 1}})


@case
def sequence_mask_zero(p):
    return _masked_sum(p, 0.0)


@case
def sequence_mask_five(p):
    return _masked_sum(p, 5.0)


def _scores(p):
    q, k = p.mx.sym.Variable("q"), p.mx.sym.Variable("k")
    return p.mx.sym.batch_dot(q + 1.0, k + 1.0, name="scores")


@case
def batch_dot_batch_axis(p):
    return p.an.classify_padding(_scores(p), {"q": (4, 5, 6),
                                              "k": (4, 6, 5)},
                                 {"batch": {"q": 0, "k": 0}})


@case
def batch_dot_contracted(p):
    return p.an.classify_padding(_scores(p), {"q": (4, 5, 6),
                                              "k": (4, 6, 5)},
                                 {"seq": {"q": 2, "k": 1}})


@case
def padding_pulls_in_shapes(p):
    net = p.mx.sym.softmax(p.mx.sym.Variable("data"), axis=-1, name="sm")
    return _default(p, net, {"data": (4, 6)},
                    pad_axes={"seq": {"data": 1}},
                    passes=("verify", "padding"))


@case
def retrace_adjacent(p):
    pol = _seq_policy(p, max_batch=2, seq_axis=0, seq_buckets=(8,))
    net = p.mx.sym.Activation(p.mx.sym.Variable("data"), act_type="tanh")
    return _default(p, net, {"data": (0, 0, 0)}, policy=pol)


#: the JAX tests' expectations, held on the port's side too
EXPECT = {
    "mlp_clean": {"batch": "row-local"},
    "softmax_over_batch": {"batch": "cross-position"},
    "padding_row_local_mlp": {"batch": "row-local"},
    "seq_sum_absorbs": {"batch": "row-local", "seq": "row-local"},
    "seq_mean_mixes": {"batch": "row-local", "seq": "cross-position"},
    "zero_chain_sigmoid": {"batch": "row-local", "seq": "cross-position"},
    "zero_chain_relu": {"batch": "row-local", "seq": "row-local"},
    "unknown_op": {"batch": "cross-position"},
    "batchnorm_inference": {"batch": "row-local"},
    "batchnorm_training": {"batch": "cross-position"},
    "reorder": {"batch": "cross-position"},
    "zoo_lenet": {"batch": "row-local"},
    "zoo_resnet18": {"batch": "row-local"},
    "greater_scalar_negative": {"batch": "row-local",
                                "seq": "cross-position"},
    "greater_scalar_positive": {"batch": "row-local", "seq": "row-local"},
    "sequence_mask_zero": {"seq": "row-local"},
    "sequence_mask_five": {"seq": "cross-position"},
    "batch_dot_batch_axis": {"batch": "row-local"},
    "batch_dot_contracted": {"seq": "cross-position"},
    "padding_pulls_in_shapes": {"seq": "cross-position"},
}


def _run(p, name):
    with p.mx.base.NameManager():
        return CASES[name](p)


def _assert_reports_match(name, jrep, trep):
    jd, td = list(jrep), list(trep)
    key = lambda d: (d.severity, d.pass_name, d.node, d.op)  # noqa: E731
    assert [key(d) for d in td] == [key(d) for d in jd], (
        "\n%s\n--- against ---\n%s" % (trep.format(), jrep.format()))
    for a, b in zip(td, jd):
        assert ta.hazard_fingerprint(a.node, a.op, a.message) == \
            ja.hazard_fingerprint(b.node, b.op, b.message), (a, b)
        assert a.provenance == b.provenance, (a, b)
        if (name, a.pass_name, a.node) not in BACKEND_MESSAGES:
            assert a.message == b.message, (a, b)
        else:
            assert a.message.split(":")[0] == b.message.split(":")[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reports_match_reference(name):
    jv, jrep = _run(J, name)
    tv, trep = _run(T, name)
    assert tv == jv
    if name in EXPECT:
        assert tv == EXPECT[name]
    _assert_reports_match(name, jrep, trep)
    assert trep.ok == jrep.ok
    assert trep.clean(strict=True) == jrep.clean(strict=True)


def test_backend_message_exceptions_are_real():
    """Each listed exception names a finding that exists, and its message
    really differs between the packages (else it should not be listed)."""
    for name, pass_name, node in BACKEND_MESSAGES:
        jm = [d.message for d in _run(J, name)[1]
              if (d.pass_name, d.node) == (pass_name, node)]
        tm = [d.message for d in _run(T, name)[1]
              if (d.pass_name, d.node) == (pass_name, node)]
        assert jm and tm and jm != tm, (name, jm, tm)


def test_structural_failure_gates_later_passes():
    """A cycle stops the pipeline after the verifier in the port too."""
    with mt.base.NameManager():
        net = _mlp(mt)
    fc1 = next(n for n in ta.GraphView(net).topo if n.name == "fc1")
    fc1.inputs[0] = (net._outputs[0][0], 0)
    report, ctx = ta.analyze(net, data_shapes={"data": (2, 4)})
    assert ctx.structural_ok is False
    assert not report.by_pass("shapes")
    err = report.errors[0]
    assert "cycle" in err.message and "fc1" in err.message


def test_crashed_pass_degrades_to_warning(monkeypatch):
    def boom(self, ctx, report):
        raise RuntimeError("kaput")

    monkeypatch.setattr(ta.ShapeDtypePass, "run", boom)
    with mt.base.NameManager():
        net = _mlp(mt)
    report, _ = ta.analyze(net, data_shapes={"data": (2, 6)},
                           passes=("verify", "shapes"))
    assert report.ok
    assert any("crashed" in d.message for d in report.warnings)
    with pytest.raises(ta.AnalysisError, match="shapes"):
        report.raise_if_errors(strict=True)


def test_shapes_pass_carries_bfloat16_by_name():
    """The analysis speaks numpy dtypes; bfloat16, which numpy lacks
    without ml_dtypes, rides as its name, and memory prices it at two
    bytes."""
    net = mt.sym.relu(mt.sym.Variable("data"), name="r")
    report, ctx = ta.analyze(net, data_shapes={"data": (2, 3)},
                             dtypes={"data": torch.bfloat16},
                             passes=("verify", "shapes", "memory"))
    assert report.ok
    head = ctx.view.heads[0]
    assert ctx.node_dtypes[(id(head[0]), 0)] == "bfloat16"
    assert ctx.memory["input_bytes"] == 12
    _, ctx2 = ta.analyze(net, data_shapes={"data": (2, 3)},
                         dtypes={"data": np.float16})
    assert ctx2.node_dtypes[(id(head[0]), 0)] == np.dtype(np.float16)


# ---------------------------------------------------------------------------
# the engines' entry points
# ---------------------------------------------------------------------------

def _resnet50_check(p, unit_impl):
    with p.mx.base.NameManager():
        net = p.get_resnet_symbol(num_classes=10, num_layers=50,
                                  image_shape=(3, 32, 32), layout="NHWC",
                                  unit_impl=unit_impl)
    return p.an.check_serving_graph(net, {"data": (32, 32, 3)},
                                    p.policy_cls(max_batch=8))


def test_check_serving_graph_on_port_policy():
    """The port's BucketPolicy has no sequence axis: check_serving_graph
    gives the batch label only, as the JAX package does for a policy
    without seq buckets, with the same report (plain ResNet-50)."""
    jv, jrep = _resnet50_check(J, "plain")
    tv, trep = _resnet50_check(T, "plain")
    assert tv == jv == {"batch": "row-local"}
    _assert_reports_match("resnet50_plain", jrep, trep)
    full, pad_axes = ta.rewrite.serving_pad_spec(
        {"data": (32, 32, 3)}, TPolicy(max_batch=8))
    assert full == {"data": (8, 32, 32, 3)}
    assert pad_axes == {"batch": {"data": 0}}


def test_fused_resnet_rows_keep_whole_pad_blocks():
    """The one graph where the verdicts differ, on purpose.  The fused
    units run on rows: ``(N, H, W, C) -> (N*H*W, C)`` and back.  The JAX
    package's reshape rule loses the batch axis there and calls every
    op after it cross-position, which would make the serving engine
    serve one request per batch; the port tracks the pad as whole H*W
    row blocks through the reshapes and the units (``_Pad.blocks``), so
    the graph is row-local.  Every diagnostic outside the padding pass
    is the JAX package's."""
    jv, jrep = _resnet50_check(J, "fused")
    tv, trep = _resnet50_check(T, "fused")
    assert jv == {"batch": "cross-position"}
    assert tv == {"batch": "row-local"}
    assert not trep.warnings
    assert {d.message.split(" — ")[0].split("] ")[-1]
            for d in jrep.warnings} == {
        "pad slots were merged into another axis upstream "
        "(reshape/flatten) and now reach non-pointwise op %r" % op
        for op in {d.op for d in jrep.warnings}}
    others = lambda r: [d for d in r if d.pass_name != "padding"]  # noqa
    assert [(d.severity, d.pass_name, d.node, d.message)
            for d in others(trep)] == [
        (d.severity, d.pass_name, d.node, d.message) for d in others(jrep)]


@pytest.mark.parametrize("in_shape,out_shape,block,want", [
    ((8, 8, 8, 256), (512, 256), 1, (0, 64)),      # rows: merge
    ((512, 256), (8, 8, 8, 256), 64, (0, 1)),      # grid: split back
    ((512, 256), (16, 4, 8, 256), 64, (0, 2)),     # split, block left
    ((512, 256), (8, 8, 8, 256), 1, None),         # granularity unknown
    ((512, 256), (4, 128, 256), 64, None),         # inner > block
    ((4, 8, 3), (32, 3), 1, (0, 8)),               # (B, T) -> B*T rows
    ((8, 4, 3), (4, 24), 1, None),                 # padded axis not lead
])
def test_blocked_reshape_rule(in_shape, out_shape, block, want):
    from mxnet_tpu_torch.analysis.padding import _map_blocked_axis
    assert _map_blocked_axis(in_shape, out_shape, 0, block) == want


def _padded_rows_graph(p, back):
    """(B, T, C) -> (B*T, C) rows -> ``back`` -> sum over axis 1:
    row-local only where ``back`` keeps each request's rows out of every
    other request's groups.  (Only reshape, Flatten and the fused units
    carry the pad's block size; any other op between would drop it and
    make the split diffuse.)"""
    x = p.mx.sym.Variable("data")
    rows = p.mx.sym.Reshape(x, shape=(-1, 3), name="rows")
    return p.mx.sym.sum(p.mx.sym.Reshape(rows, shape=back, name="back"),
                        axis=1, name="pool")


@pytest.mark.parametrize("back,want", [
    ((4, 8, 3), "row-local"), ((16, 2, 3), "row-local"),
    ((2, 16, 3), "cross-position")])
def test_rows_round_trip_verdicts(back, want):
    """(16, 2, 3) groups rows within one request, (2, 16, 3) puts two
    requests in one group; the JAX package calls all three
    cross-position (diffuse)."""
    verdicts = {}
    for p in (J, T):
        with p.mx.base.NameManager():
            net = _padded_rows_graph(p, back)
        verdicts[p] = p.an.classify_padding(
            net, {"data": (4, 8, 3)}, {"batch": {"data": 0}})[0]
    assert verdicts[J] == {"batch": "cross-position"}
    assert verdicts[T] == {"batch": want}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def decoder():
    bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                               "decode_bench.py"))
    with mj.base.NameManager():
        jt, t_info, jd, d_info, _ = bench.build_spec_models(
            vocab=32, d=16, max_len=32, layers=2, seed=0)
    return dict(jt=jt, jd=jd, t=mt.sym.load_json(jt.tojson()),
                d=mt.sym.load_json(jd.tojson()), t_info=t_info,
                d_info=d_info)


@pytest.mark.parametrize("which", ["t", "d"])
def test_check_decode_step_matches_reference(decoder, which):
    info = decoder[which + "_info"]
    shapes = {"token": (4,), "pos": (4,)}
    shapes.update({s["name"]: (4,) + tuple(s["shape"]) for s in info})
    names = [s["name"] for s in info]
    jv, jrep = ja.check_decode_step(decoder["j" + which], shapes,
                                    state_names=names)
    tv, trep = ta.check_decode_step(decoder[which], shapes,
                                    state_names=names)
    assert tv == jv == "row-local"
    _assert_reports_match("decode_" + which, jrep, trep)


def test_check_decode_step_flags_slot_mixing(decoder):
    """A step that sums its state over the slot axis is cross-position
    with the state seeded pad-dirty, in both packages."""
    out = {}
    for p in (J, T):
        with p.mx.base.NameManager():
            cache = p.mx.sym.Variable("cache")
            tok = p.mx.sym.Variable("token")
            mixed = p.mx.sym.broadcast_add(
                cache, p.mx.sym.sum(cache, axis=0, keepdims=True),
                name="mix")
            net = p.mx.sym.Group([tok * 1.0, mixed])
        out[p] = p.an.check_decode_step(
            net, {"token": (4,), "cache": (4, 8, 2)},
            state_names=["cache"])
    assert out[T][0] == out[J][0] == "cross-position"
    _assert_reports_match("slot_mixing", out[J][1], out[T][1])


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_flags_match_reference():
    """stochastic and host_sync, on every op both packages register, are
    the JAX package's; and the retrace linter's host-sync verdict (flag,
    else a scan of the impl's source) agrees op for op.  No port op reads
    device values back on the host where the JAX op does not."""
    shared = sorted(set(t_reg._REGISTRY) & set(j_reg._REGISTRY))
    assert len(shared) > 150
    for name in shared:
        top, jop = t_reg.get_op(name), j_reg.get_op(name)
        assert (top.stochastic, top.host_sync) == \
            (jop.stochastic, jop.host_sync), name
        if name.startswith("_lint_"):
            continue
        assert t_retrace._op_host_syncs(top) == \
            j_retrace._op_host_syncs(jop), name
    assert t_reg.get_op("Dropout").stochastic
    assert t_reg.get_op("RNN").stochastic


def _registered_names(path):
    """Every name and alias a module registers through ``register``."""
    out = []
    for call in ast.walk(ast.parse(open(path).read())):
        if not (isinstance(call, ast.Call) and getattr(
                call.func, "id", getattr(call.func, "attr", None))
                == "register" and call.args
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            continue
        out.append(call.args[0].value)
        for kw in call.keywords:
            if kw.arg == "aliases" and isinstance(kw.value,
                                                  (ast.List, ast.Tuple)):
                out.extend(e.value for e in kw.value.elts
                           if isinstance(e, ast.Constant))
    return out


def test_no_builtin_module_registers_a_name_twice():
    """A second registration silently replaces the first: the verifier's
    registry checks would then read whichever copy came last."""
    files = sorted(glob.glob(os.path.join(ROOT, "mxnet_tpu_torch", "**",
                                          "*.py"), recursive=True))
    seen = {}
    for path in files:
        for name in _registered_names(path):
            assert name not in seen, (name, seen.get(name), path)
            seen[name] = path
    assert "slice_axis" in seen and "Pad" in seen
    # and the live registry holds one OpDef per primary name
    assert len({id(t_reg.get_op(n)) for n in t_reg.list_ops()}) == \
        len(t_reg._REGISTRY)
