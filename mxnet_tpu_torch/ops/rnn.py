"""The fused multi-layer RNN op (RNN, LSTM, GRU; uni- or bidirectional).

Counterpart of ``mxnet_tpu/ops/rnn.py``: one packed parameter blob in
cuDNN's order (every layer's and direction's i2h and h2h weights, then
every bias), gate order LSTM ``[i, f, c, o]`` and GRU ``[r, z, n]``, data
time-major (TNC).  The reference runs each layer as a ``lax.scan``; here
the input projection of all timesteps is one product, and a Python loop
over time runs each step on torch's operators (cuBLAS on the card).  The
reverse direction returns its outputs in the original time order.  The
GRU keeps the h2h bias inside ``r * nh`` as cuDNN does.  Inter-layer
dropout ``p`` draws its mask from the explicit generator of the data's
device (``random.generator``), where the reference folds the layer into
its key; ``lstm_state_clip_min``/``_max`` are accepted and, as in the
reference, never read.  ``_begin_state`` makes the zero state the
symbolic cells start from.
"""
from __future__ import annotations

import torch

from .registry import register, P
from .. import random as _random
from ..context import Context

__all__ = ["rnn_param_size"]

_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _param_layout(mode, input_size, state_size, num_layers, bidirectional):
    """Yield (kind, layer, direction, shape, offset) for the packed blob —
    weights first (i2h, h2h per layer·direction), then biases, cuDNN order."""
    ngates = _NGATES[mode]
    d = 2 if bidirectional else 1
    entries = []
    off = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * d
        for direction in range(d):
            for kind, cols in (("i2h", isz), ("h2h", state_size)):
                shape = (ngates * state_size, cols)
                entries.append((kind, layer, direction, shape, off))
                off += shape[0] * shape[1]
    for layer in range(num_layers):
        for direction in range(d):
            for kind in ("i2h_bias", "h2h_bias"):
                shape = (ngates * state_size,)
                entries.append((kind, layer, direction, shape, off))
                off += shape[0]
    return entries, off


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    return _param_layout(mode, input_size, state_size, num_layers,
                         bidirectional)[1]


def _unpack(params, mode, input_size, state_size, num_layers, bidirectional):
    entries, _ = _param_layout(mode, input_size, state_size, num_layers,
                               bidirectional)
    out = {}
    for kind, layer, direction, shape, off in entries:
        n = 1
        for s in shape:
            n *= s
        out[(kind, layer, direction)] = params[off:off + n].reshape(shape)
    return out


def _run_layer(x, h, c, wi, wh, bi, bh, mode, reverse=False):
    """One layer and direction over x (T, N, I) from states h, c (N, H):
    (outputs (T, N, H) in x's time order, last h, last c)."""
    T = x.shape[0]
    whT = wh.t()
    if mode == "gru":
        gx_all = torch.addmm(bi, x.reshape(T * x.shape[1], -1), wi.t())
    else:
        # both biases folded into the one product over all timesteps
        gx_all = torch.addmm(bi + bh, x.reshape(T * x.shape[1], -1), wi.t())
    gx_all = gx_all.reshape(T, x.shape[1], -1)
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gx = gx_all[t]
        if mode == "lstm":
            gates = torch.addmm(gx, h, whT)
            i, f, _, o = torch.sigmoid(gates).chunk(4, 1)
            g = torch.tanh(gates.chunk(4, 1)[2])
            c = torch.addcmul(f * c, i, g)
            h = o * torch.tanh(c)
        elif mode == "gru":
            gh = torch.addmm(bh, h, whT)
            rx, zx, nx = gx.chunk(3, 1)
            rh, zh, nh = gh.chunk(3, 1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        else:
            pre = torch.addmm(gx, h, whT)
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        hs[t] = h
    return torch.stack(hs), h, c


_RNN_PARAMS = {
    "state_size": P(int), "num_layers": P(int),
    "bidirectional": P(bool, False),
    "mode": P(str, choices=["rnn_relu", "rnn_tanh", "lstm", "gru"]),
    "p": P(float, 0.0), "state_outputs": P(bool, False),
    "lstm_state_clip_min": P("float_or_none", None),
    "lstm_state_clip_max": P("float_or_none", None),
}


def _rnn_fill(attrs, in_shapes):
    out = list(in_shapes)
    data = out[0]
    if data is not None:
        isz = data[2]
        h = attrs["state_size"]
        L = attrs["num_layers"]
        d = 2 if attrs["bidirectional"] else 1
        if len(out) > 1 and out[1] is None:
            out[1] = (rnn_param_size(attrs["mode"], isz, h, L,
                                     attrs["bidirectional"]),)
        if len(out) > 2 and out[2] is None:
            out[2] = (L * d, data[1], h)
        if len(out) > 3 and out[3] is None:
            out[3] = (L * d, data[1], h)
    return out


def _rnn_nin(attrs):
    return 4 if (attrs or {}).get("mode") == "lstm" else 3


def _rnn_nout(attrs):
    if not (attrs or {}).get("state_outputs"):
        return 1
    return 3 if attrs.get("mode") == "lstm" else 2


@register("RNN", aliases=["rnn"], nin=_rnn_nin,
          input_names=["data", "parameters", "state", "state_cell"],
          nout=_rnn_nout, mode_dependent=True, stochastic=True,
          fill_shapes=_rnn_fill, params=_RNN_PARAMS)
def rnn(attrs, data, parameters, state, state_cell=None):
    """data (T, N, I) time-major; state (and, for the LSTM, state_cell)
    (layers * directions, N, H).  Outputs: the last layer's (T, N, H *
    directions), then with ``state_outputs`` the last states."""
    mode = attrs["mode"]
    h = attrs["state_size"]
    L = attrs["num_layers"]
    bidi = attrs["bidirectional"]
    d = 2 if bidi else 1
    w = _unpack(parameters, mode, data.shape[2], h, L, bidi)
    x = data
    h_outs, c_outs = [], []
    for layer in range(L):
        outs = []
        for direction in range(d):
            k = layer * d + direction
            hi = state[k]
            ci = state_cell[k] if state_cell is not None \
                else torch.zeros_like(hi)
            hs, hT, cT = _run_layer(
                x, hi, ci, w[("i2h", layer, direction)],
                w[("h2h", layer, direction)],
                w[("i2h_bias", layer, direction)],
                w[("h2h_bias", layer, direction)], mode,
                reverse=direction == 1)
            outs.append(hs)
            h_outs.append(hT)
            c_outs.append(cT)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if attrs["p"] > 0 and attrs.get("_training", False) \
                and layer < L - 1 and x.device.type != "meta":
            keep = 1.0 - attrs["p"]
            gen = _random.generator(Context.of(x.device))
            u = torch.rand(x.shape, generator=gen, device=x.device)
            x = torch.where(u < keep, x / keep, torch.zeros_like(x))
    if not attrs["state_outputs"]:
        return (x,)
    if mode == "lstm":
        return x, torch.stack(h_outs), torch.stack(c_outs)
    return x, torch.stack(h_outs)


@register("_begin_state", nin=1, input_names=["data"],
          params={"num_hidden": P(int), "batch_axis": P(int, 0)})
def _begin_state(attrs, data):
    """Zeros (batch, num_hidden) in data's dtype, the batch taken from
    ``batch_axis`` of any batch-major input: the symbolic cells' default
    initial state."""
    b = data.shape[attrs["batch_axis"]]
    return torch.zeros((b, attrs["num_hidden"]), dtype=data.dtype,
                       device=data.device)
