"""The recurrent path on the card against its own CPU run: the fused
``RNN`` op in its four modes, the Sequence ops, a Gluon LSTM layer and
one BucketingModule step of examples/rnn_ptb.py's model.

The tests need a CUDA card and skip where there is none.  This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_rnn_cuda.py -q

TF32 is off, so both sides compute in float32; cuBLAS sums in another
order than the CPU: forward values within 1e-5 absolute, gradients
within 1e-4 relative L2.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import invoke
from mxnet_tpu_torch.ops.rnn import rnn_param_size

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _rel(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


def _run(device, mode, ins, attrs, cots):
    ts = [torch.from_numpy(a).to(device).requires_grad_() for a in ins]
    outs = invoke("RNN", attrs, *ts, training=True)
    torch.autograd.backward(list(outs),
                            [torch.from_numpy(c).to(device) for c in cots])
    return ([o.detach().cpu() for o in outs], [t.grad.cpu() for t in ts])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_rnn_op_on_card_matches_cpu(cuda_device, mode):
    T, N, I, H, L = 12, 16, 24, 32, 2
    rng = np.random.default_rng(0)
    ins = [rng.standard_normal((T, N, I)).astype(np.float32),
           (rng.standard_normal(rnn_param_size(mode, I, H, L, True))
            * 0.2).astype(np.float32),
           rng.standard_normal((2 * L, N, H)).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.standard_normal((2 * L, N, H)).astype(np.float32))
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=True,
                 state_outputs=True)
    shapes = [(T, N, 2 * H)] + [(2 * L, N, H)] * (len(ins) - 2)
    cots = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    card = _run(cuda_device, mode, ins, attrs, cots)
    host = _run(torch.device("cpu"), mode, ins, attrs, cots)
    for g, w in zip(card[0], host[0]):
        assert float((g - w).abs().max()) <= FWD_ATOL
    for g, w in zip(card[1], host[1]):
        assert _rel(g, w) < GRAD_RTOL


@pytest.mark.cuda
def test_sequence_ops_on_card_match_cpu(cuda_device):
    x = torch.randn(6, 4, 3, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([6.0, 1.0, 3.0, 4.0])
    for op in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        attrs = {"use_sequence_length": True}
        host = invoke(op, attrs, x, lens)[0]
        card = invoke(op, attrs, x.to(cuda_device), lens.to(cuda_device))[0]
        assert torch.equal(card.cpu(), host), op


@pytest.mark.cuda
def test_gluon_lstm_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((10, 8, 20)).astype(np.float32)
    runs = []
    for ctx in (mt.gpu(0), mt.cpu()):
        layer = mt.gluon.rnn.LSTM(32, num_layers=2, input_size=20,
                                  prefix="lstm_")
        layer.initialize(ctx=ctx)
        vals = np.random.default_rng(3)
        for k, p in sorted(layer.collect_params().items()):
            p.set_data(mt.nd.array((vals.standard_normal(p.shape) * 0.2)
                                   .astype(np.float32), ctx=ctx))
        xs = mt.nd.array(x, ctx=ctx)
        with mt.autograd.record():
            y = layer(xs)
        y.backward()
        runs.append((y._data.cpu(), {k: p.grad()._data.cpu() for k, p in
                                     layer.collect_params().items()}))
    (yc, gc), (yh, gh) = runs
    assert float((yc - yh).abs().max()) <= FWD_ATOL
    for k in gh:
        assert _rel(gc[k], gh[k]) < GRAD_RTOL, k


@pytest.mark.cuda
def test_bucketing_step_on_card_matches_cpu(cuda_device):
    """One forward/backward of examples/rnn_ptb.py's unrolled LSTM model
    (vocab 64, widths 32) at bucket 10 through BucketingModule."""
    V, E, HID, B = 64, 32, 32, 16

    def sym_gen(seq_len):
        stack = mt.rnn.SequentialRNNCell()
        for i in range(2):
            stack.add(mt.rnn.LSTMCell(HID, prefix="lstm_l%d_" % i))
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=V, output_dim=E,
                                 name="embed")
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.FullyConnected(mt.sym.Reshape(outputs,
                                                    shape=(-1, HID)),
                                     num_hidden=V, name="pred")
        out = mt.sym.SoftmaxOutput(pred, mt.sym.Reshape(label, shape=(-1,)),
                                   name="softmax", use_ignore=True,
                                   ignore_label=0, normalization="valid")
        return out, ("data",), ("softmax_label",)
    rng = np.random.default_rng(4)
    data = rng.integers(0, V, (B, 10)).astype(np.float32)
    label = np.concatenate([data[:, 1:], np.zeros((B, 1), np.float32)], 1)
    sym = sym_gen(10)[0]
    args, _ = mt.convert.random_params(
        sym, {"data": (B, 10), "softmax_label": (B, 10)}, seed=5)
    grads = []
    for ctx in (mt.gpu(0), mt.cpu()):
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                     context=ctx)
        mod.bind([mt.io.DataDesc("data", (B, 10))],
                 [mt.io.DataDesc("softmax_label", (B, 10))])
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=ctx)
                                    for k, v in args.items()})
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(data, ctx=mt.cpu())],
            [mt.nd.array(label, ctx=mt.cpu())], bucket_key=10))
        ex = mod._curr_module._exec
        grads.append({k: ex.grad_dict[k]._data.cpu() for k in args})
    card, host = grads
    num = sum(float((card[k] - host[k]).double().norm() ** 2) for k in host)
    den = sum(float(host[k].double().norm() ** 2) for k in host)
    assert (num / den) ** 0.5 < GRAD_RTOL
