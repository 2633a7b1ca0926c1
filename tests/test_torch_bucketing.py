"""BucketSentenceIter, BucketingModule and the RNN checkpoints against the
JAX package, on the CPU.

``examples/rnn_ptb.py``'s model at small widths (vocab 16, embed 8,
hidden 12, two LSTMCells, buckets 2, 3, 4, batch 8): the iterator's
batches equal the reference's bit for bit over two epochs (the same
``random.Random`` shuffles); one epoch of ``BucketingModule.fit`` (SGD at
the example's lr 1.0, ``Perplexity(ignore_label=0)``) from the same
weights in both packages gives the perplexity within 1e-5 relative and
every trained parameter within 1e-4 relative L2 (float32 sums in another
order, carried through the epoch); each bucket binds exactly one Executor;
a bucket switch copies the parameters without a host copy; RNN
checkpoints written by either package load in the other, bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

V, E, HID, BATCH = 16, 8, 12, 8
BUCKETS = [2, 3, 4]
PPL_RTOL = 1e-5
PARAM_RTOL = 1e-4


def _sentences(n=90, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, V, int(rng.integers(2, 5)))]
            for _ in range(n)]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _sym_gen(pkg):
    """examples/rnn_ptb.py's sym_gen over ``pkg``."""
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(HID, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, HID))
        pred = pkg.sym.FullyConnected(pred, num_hidden=V, name="pred")
        label_f = pkg.sym.Reshape(label, shape=(-1,))
        out = pkg.sym.SoftmaxOutput(pred, label_f, name="softmax",
                                    use_ignore=True, ignore_label=0,
                                    normalization="valid")
        return out, ("data",), ("softmax_label",)
    return sym_gen, stack


def test_bucket_sentence_iter_bit_for_bit():
    sents = _sentences()
    coded = {}
    for pkg in (mt, mx):
        it = pkg.rnn.BucketSentenceIter(sents, BATCH, buckets=BUCKETS,
                                        invalid_label=0, seed=3)
        seen = []
        for _ in range(2):
            for b in it:
                seen.append((b.bucket_key, b.data[0].asnumpy(),
                             b.label[0].asnumpy(),
                             [tuple(d.shape) for d in b.provide_data],
                             b.pad))
            it.reset()
        coded[pkg] = (seen, it.default_bucket_key,
                      [tuple(d.shape) for d in it.provide_data])
    (got, gk, gp), (want, wk, wp) = coded[mt], coded[mx]
    assert (gk, gp) == (wk, wp) and len(got) == len(want) > 8
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3] and g[4] == w[4]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    words = [["a", "b"], ["b", "c", "a"]]
    assert mt.rnn.encode_sentences(words, start_label=1) == \
        mx.rnn.encode_sentences(words, start_label=1)


def _fit(pkg, args):
    sym_gen, _ = _sym_gen(pkg)
    it = pkg.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                    invalid_label=0)
    mod = pkg.mod.BucketingModule(sym_gen,
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    ppl = pkg.metric.Perplexity(ignore_label=0)
    mod.fit(it, num_epoch=1, eval_metric=ppl,
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()},
            optimizer_params={"learning_rate": 1.0})
    return mod, ppl.get()[1], {k: v.asnumpy()
                               for k, v in mod.get_params()[0].items()}


@pytest.fixture(scope="module")
def weights():
    sym, _, _ = _sym_gen(mt)[0](max(BUCKETS))
    args, _ = mt.convert.random_params(
        sym, {"data": (BATCH, max(BUCKETS)),
              "softmax_label": (BATCH, max(BUCKETS))}, seed=0)
    return args


def test_bucketing_fit_matches_jax(weights):
    tmod, tppl, tparams = _fit(mt, weights)
    jmod, jppl, jparams = _fit(mx, weights)
    assert abs(tppl - jppl) <= PPL_RTOL * jppl, (tppl, jppl)
    assert sorted(tparams) == sorted(jparams) == sorted(weights)
    for k in jparams:
        assert not np.array_equal(jparams[k], weights[k]), k
        assert _rel(tparams[k], jparams[k]) < PARAM_RTOL, k
    # one Executor per bucket, none bound twice across another epoch
    assert sorted(tmod._buckets) == BUCKETS
    execs = {k: m._exec for k, m in tmod._buckets.items()}
    assert len({id(e) for e in execs.values()}) == len(BUCKETS)
    it = mt.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                   invalid_label=0)
    tmod.fit(it, num_epoch=2, begin_epoch=1,
             eval_metric=mt.metric.Perplexity(ignore_label=0),
             optimizer_params={"learning_rate": 1.0})
    assert {k: m._exec for k, m in tmod._buckets.items()} == execs


def test_bucket_switch_copies_on_device(weights, monkeypatch):
    """Forward, backward and update across bucket switches (and
    ``prepare``) read no array back to the host."""
    sym_gen, _ = _sym_gen(mt)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=max(BUCKETS),
                                 context=mt.cpu())
    it = mt.rnn.BucketSentenceIter(_sentences(), BATCH, buckets=BUCKETS,
                                   invalid_label=0)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in weights.items()})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    batches = list(it)

    def no_host(self):
        raise AssertionError("a parameter went through the host")
    monkeypatch.setattr(mt.nd.NDArray, "asnumpy", no_host)
    keys = set()
    for b, nxt in zip(batches, batches[1:] + [None]):
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        if nxt is not None:
            mod.prepare(nxt)
        keys.add(b.bucket_key)
    assert keys == set(BUCKETS)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rnn_checkpoints_either_way(tmp_path, writer):
    """save_rnn_checkpoint packs an unfused stack's per-gate weights (and
    a fused cell's into its blob), load_rnn_checkpoint unpacks them, in
    either package's files."""
    rng = np.random.default_rng(7)
    per_gate = {}
    for layer in range(2):
        for group, cols in (("i2h", E), ("h2h", HID)):
            for gate in ("_i", "_f", "_c", "_o"):
                p = "lstm_l%d_%s%s_" % (layer, group, gate)
                per_gate[p + "weight"] = rng.standard_normal(
                    (HID, cols)).astype(np.float32)
                per_gate[p + "bias"] = rng.standard_normal(HID) \
                    .astype(np.float32)
    prefix = str(tmp_path / "lm")
    pkgs = (mx, mt) if writer == "jax" else (mt, mx)
    w_pkg, r_pkg = pkgs
    sym_gen, stack = _sym_gen(w_pkg)
    w_pkg.rnn.save_rnn_checkpoint(
        stack, prefix, 2, sym_gen(4)[0],
        {k: w_pkg.nd.array(v, ctx=w_pkg.cpu()) for k, v in per_gate.items()},
        {})
    _, r_stack = _sym_gen(r_pkg)
    sym, arg, aux = r_pkg.rnn.load_rnn_checkpoint(r_stack, prefix, 2)
    assert sorted(arg) == sorted(per_gate) and not aux
    for k, v in per_gate.items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v)
    assert sym.list_arguments() == sym_gen(4)[0].list_arguments()
    # the packed file holds the cells' fused i2h/h2h names
    _, packed, _ = r_pkg.model.load_checkpoint(prefix, 2)
    assert "lstm_l0_i2h_weight" in packed
    assert packed["lstm_l0_i2h_weight"].shape == (4 * HID, E)


def test_do_rnn_checkpoint_and_fused_blob(tmp_path):
    """do_rnn_checkpoint's callback writes every ``period`` epochs; a
    fused cell's blob round-trips through the JAX package's loader."""
    size = mt.ops.rnn.rnn_param_size("lstm", E, HID, 2, False)
    blob = np.random.default_rng(8).standard_normal(size) \
        .astype(np.float32)
    cell = mt.rnn.FusedRNNCell(HID, num_layers=2, prefix="lstm_")
    out, _ = cell.unroll(4, inputs=mt.sym.Variable("data"),
                         merge_outputs=True)
    args = cell.unpack_weights(
        {"lstm_parameters": mt.nd.array(blob, ctx=mt.cpu())})
    prefix = str(tmp_path / "fused")
    cb = mt.rnn.do_rnn_checkpoint(cell, prefix, period=2)
    cb(0, out, args, {})
    cb(1, out, args, {})
    jcell = mx.rnn.FusedRNNCell(HID, num_layers=2, prefix="lstm_")
    _, jargs, _ = mx.rnn.load_rnn_checkpoint(jcell, prefix, 2)
    repacked = jcell.pack_weights(jargs)
    np.testing.assert_array_equal(repacked["lstm_parameters"].asnumpy(),
                                  blob)
    with pytest.raises(OSError):
        mt.model.load_checkpoint(prefix, 1)
