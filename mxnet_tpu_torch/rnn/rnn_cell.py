"""Symbolic RNN cells and their unroll, for Module and BucketingModule.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py``: RNNParams, BaseRNNCell
(``begin_state``, ``unpack_weights``/``pack_weights``, ``unroll``),
RNNCell, LSTMCell, GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
ResidualCell, ZoneoutCell, BidirectionalCell and FusedRNNCell (the fused
``RNN`` op of ``ops/rnn.py``, with ``unfuse``).  The graphs, parameter
names and weight layouts are the reference's, so symbols, checkpoints and
weights carry between the packages.  ``unpack_weights`` and
``pack_weights`` slice and concatenate NDArrays on their own device (a
copy each, as the reference's are).
"""
from __future__ import annotations

import numpy as np

from .. import symbol as sym
from ..base import MXNetError
from ..ndarray import concatenate

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ResidualCell", "ZoneoutCell", "BidirectionalCell",
           "FusedRNNCell"]


class RNNParams:
    """Shared weight Variables, created on first ``get``."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """One recurrence step over symbols."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        return self._params

    @property
    def prefix(self):
        return self._prefix

    @property
    def state_info(self):
        """[{'shape': (0, H), '__layout__': 'NC'}, ...]; 0 is the batch."""
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def __call__(self, inputs, states):
        """One step: (output symbol, [next state symbols])."""
        raise NotImplementedError

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def begin_state(self, func=None, anchor=None, **kwargs):
        """Initial states: zeros shaped from ``anchor`` (any batch-major
        input symbol) through the ``_begin_state`` op, or
        ``func(name=..., **kwargs)`` (``sym.Variable`` for fed states)."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if func is not None:
                states.append(func(name="%sbegin_state_%d"
                              % (self._prefix, self._init_counter), **kwargs))
                continue
            if anchor is None:
                raise MXNetError("begin_state needs an `anchor` symbol to "
                                 "infer the batch dimension (or pass func=)")
            states.append(sym._begin_state(
                anchor, num_hidden=info["shape"][1],
                name="%sbegin_state_%d" % (self._prefix,
                                           self._init_counter)))
        return states

    def begin_state_arrays(self, batch_size, dtype=None):
        """Zero initial states as host numpy arrays, one per
        ``state_info`` entry, the batch placeholder (0) set to
        ``batch_size``."""
        dt = np.dtype(dtype or np.float32)
        return [np.zeros(tuple(batch_size if d == 0 else d
                               for d in info["shape"]), dtype=dt)
                for info in self.state_info]

    def unpack_weights(self, args):
        """Split this cell's stacked-gate i2h/h2h weights and biases into
        per-gate entries: ``<prefix>i2h_weight`` (4H, C) becomes
        ``<prefix>i2h_i_weight`` ... each (H, C).  Identity for cells
        without gates."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                name = "%s%s_%s" % (self._prefix, group, kind)
                if name not in args:
                    continue
                blob = args.pop(name)
                for j, gate in enumerate(self._gate_names):
                    args["%s%s%s_%s" % (self._prefix, group, gate, kind)] = \
                        blob[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """Inverse of ``unpack_weights``."""
        args = dict(args)
        if not self._gate_names:
            return args
        for group in ("i2h", "h2h"):
            for kind in ("weight", "bias"):
                gate0 = "%s%s%s_%s" % (self._prefix, group,
                                       self._gate_names[0], kind)
                if gate0 not in args:
                    continue
                parts = [args.pop("%s%s%s_%s" % (self._prefix, group, g,
                                                 kind))
                         for g in self._gate_names]
                args["%s%s_%s" % (self._prefix, group, kind)] = \
                    concatenate(parts, axis=0)
        return args

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        """Unroll ``length`` steps.  ``inputs``: one symbol, (batch, T, C)
        for NTC, sliced per step, or a list of per-step symbols (None:
        variables ``<input_prefix>t<i>_data``).  Returns (outputs,
        states); outputs is one (batch, T, H) symbol with
        ``merge_outputs``, else a list."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [sym.Variable("%st%d_data" % (input_prefix, i))
                      for i in range(length)]
        if isinstance(inputs, sym.Symbol):
            if len(inputs) != 1:
                raise MXNetError("unroll expects a single-output symbol")
            anchor = inputs
            inputs = list(sym.SliceChannel(inputs, axis=axis,
                                           num_outputs=length,
                                           squeeze_axis=True))
        else:
            anchor = inputs[0]
        if begin_state is None:
            begin_state = self.begin_state(anchor=anchor)
        states = begin_state
        outputs = []
        for t in range(length):
            out, states = self(inputs[t], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.Concat(
                *[sym.expand_dims(o, axis=axis) for o in outputs], dim=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Elman RNN: h' = act(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, weight=self.params.get("i2h_weight"),
                                 bias=self.params.get("i2h_bias"),
                                 num_hidden=self._num_hidden,
                                 name=name + "i2h")
        h2h = sym.FullyConnected(states[0],
                                 weight=self.params.get("h2h_weight"),
                                 bias=self.params.get("h2h_bias"),
                                 num_hidden=self._num_hidden,
                                 name=name + "h2h")
        out = sym.Activation(i2h + h2h, act_type=self._activation,
                             name=name + "out")
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM, gate order i, f, c, o.  ``forget_bias`` is the i2h bias's
    initial value (``init=LSTMBias``), not a constant of the graph, so a
    restored checkpoint does not get it twice."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        from .. import initializer as _init
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        h = self._num_hidden
        i2h = sym.FullyConnected(
            inputs, weight=self.params.get("i2h_weight"),
            bias=self.params.get(
                "i2h_bias",
                init=_init.LSTMBias(forget_bias=self._forget_bias)),
            num_hidden=h * 4, name=name + "i2h")
        h2h = sym.FullyConnected(states[0],
                                 weight=self.params.get("h2h_weight"),
                                 bias=self.params.get("h2h_bias"),
                                 num_hidden=h * 4, name=name + "h2h")
        gates = sym.SliceChannel(i2h + h2h, num_outputs=4, axis=1,
                                 name=name + "slice")
        in_gate = sym.Activation(gates[0], act_type="sigmoid")
        forget_gate = sym.Activation(gates[1], act_type="sigmoid")
        in_trans = sym.Activation(gates[2], act_type="tanh")
        out_gate = sym.Activation(gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.Activation(next_c, act_type="tanh",
                                           name=name + "state_act")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU, gate order r, z, n."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        h = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self.params.get("i2h_weight"),
                                 bias=self.params.get("i2h_bias"),
                                 num_hidden=h * 3, name=name + "i2h")
        h2h = sym.FullyConnected(states[0],
                                 weight=self.params.get("h2h_weight"),
                                 bias=self.params.get("h2h_bias"),
                                 num_hidden=h * 3, name=name + "h2h")
        i2h_g = sym.SliceChannel(i2h, num_outputs=3, axis=1)
        h2h_g = sym.SliceChannel(h2h, num_outputs=3, axis=1)
        reset = sym.Activation(i2h_g[0] + h2h_g[0], act_type="sigmoid")
        update = sym.Activation(i2h_g[1] + h2h_g[1], act_type="sigmoid")
        cand = sym.Activation(i2h_g[2] + reset * h2h_g[2], act_type="tanh")
        next_h = update * states[0] + (1.0 - update) * cand
        return next_h, [next_h]


class SequentialRNNCell(BaseRNNCell):
    """Cells stacked: each step's output is the next cell's input."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        return self

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        out = inputs
        for c in self._cells:
            n = len(c.state_info)
            out, ns = c(out, states[pos:pos + n])
            next_states.extend(ns)
            pos += n
        return out, next_states

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()


class DropoutCell(BaseRNNCell):
    """Dropout on each step's input; no state."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        self._counter += 1
        out = sym.Dropout(inputs, p=self._dropout,
                          name="%st%d" % (self._prefix, self._counter)) \
            if self._dropout > 0 else inputs
        return out, states


class ModifierCell(BaseRNNCell):
    """Wraps a base cell and shares its parameters."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix, params=base_cell.params)
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def reset(self):
        super().reset()
        self.base_cell.reset()


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state element keeps its previous value
    with probability ``zoneout_outputs`` / ``zoneout_states`` (masks from
    Dropout, so from the device's generator in training)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo_out = zoneout_outputs
        self._zo_state = zoneout_states
        self._prev = None

    def reset(self):
        super().reset()
        self._prev = None

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)

        def mix(p, new, old):
            if p <= 0 or old is None:
                return new
            mask = sym.Dropout(sym.ones_like(new), p=p)
            # Dropout scales what it keeps by 1/(1-p); back to {0, 1}
            keep = mask * (1.0 - p)
            return keep * new + (1.0 - keep) * old
        mixed_out = mix(self._zo_out, out, self._prev)
        mixed_states = [mix(self._zo_state, ns, s)
                        for ns, s in zip(next_states, states)]
        self._prev = out
        return mixed_out, mixed_states


class BidirectionalCell(BaseRNNCell):
    """A forward and a backward cell over the sequence, outputs
    concatenated; only through ``unroll``."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l = l_cell
        self._r = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def begin_state(self, **kwargs):
        return self._l.begin_state(**kwargs) + self._r.begin_state(**kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll()")

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, sym.Symbol):
            anchor = inputs
            inputs = list(sym.SliceChannel(inputs, axis=axis,
                                           num_outputs=length,
                                           squeeze_axis=True))
        else:
            anchor = inputs[0]
        if begin_state is None:
            begin_state = self.begin_state(anchor=anchor)
        nl = len(self._l.state_info)
        l_out, l_states = self._l.unroll(length, inputs,
                                         begin_state[:nl], layout=layout)
        r_out, r_states = self._r.unroll(length, list(reversed(inputs)),
                                         begin_state[nl:], layout=layout)
        r_out = list(reversed(r_out))
        outputs = [sym.Concat(lo, ro, dim=1,
                              name="%st%d" % (self._output_prefix, t))
                   for t, (lo, ro) in enumerate(zip(l_out, r_out))]
        if merge_outputs:
            outputs = sym.Concat(
                *[sym.expand_dims(o, axis=axis) for o in outputs], dim=axis)
        return outputs, l_states + r_states


class FusedRNNCell(BaseRNNCell):
    """The fused multi-layer ``RNN`` op (``ops/rnn.py``) as a cell, its
    weights one packed blob ``<prefix>parameters`` (initializer
    ``FusedRNN``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None, params=None,
                 forget_bias=1.0):
        from .. import initializer as _init
        prefix = "%s_" % mode if prefix is None else prefix
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidi = bidirectional
        self._dropout = dropout
        self._parameter = self.params.get(
            "parameters", init=_init.FusedRNN(
                None, num_hidden, num_layers, mode, bidirectional,
                forget_bias))

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"),
                "gru": ("_r", "_z", "_o")}[self._mode]

    @property
    def _directions(self):
        return ["l", "r"] if self._bidi else ["l"]

    def _blob_entries(self, num_input):
        """Per-gate (name, shape, offset) for the packed blob, in offset
        order, derived from the RNN op's own layout so the two cannot
        drift."""
        from ..ops.rnn import _param_layout
        entries, total = _param_layout(self._mode, num_input,
                                       self._num_hidden, self._num_layers,
                                       self._bidi)
        h = self._num_hidden
        out = []
        for kind, layer, direction, shape, off in entries:
            group = kind.split("_")[0]                     # i2h / h2h
            is_bias = kind.endswith("bias")
            cols = 1 if is_bias else shape[1]
            for j, gate in enumerate(self._gate_names):
                name = "%s%s%d_%s%s_%s" % (
                    self._prefix, self._directions[direction], layer, group,
                    gate, "bias" if is_bias else "weight")
                gshape = (h,) if is_bias else (h, cols)
                out.append((name, gshape, off + j * h * cols))
        return out, total

    def _infer_num_input(self, blob_size):
        """The layer-0 input width, from the packed blob's size."""
        d = len(self._directions)
        m = len(self._gate_names)
        h = self._num_hidden
        rest = blob_size - self._num_layers * d * 2 * m * h  # biases
        for _ in range(1, self._num_layers):
            rest -= d * m * h * (d * h + h)
        li = rest // (d * m * h) - h
        if li <= 0:
            raise MXNetError("invalid fused parameter size %d" % blob_size)
        return li

    def unpack_weights(self, args):
        """The packed blob -> per-gate i2h/h2h entries
        (``<prefix>l0_i2h_i_weight``, ...), so fused checkpoints restore
        into unfused cells and back."""
        args = dict(args)
        pname = self._parameter.name
        if pname not in args:
            return args
        blob = args.pop(pname).reshape((-1,))
        entries, total = self._blob_entries(self._infer_num_input(blob.size))
        if total != blob.size:
            raise MXNetError("fused parameter size %d does not match the "
                             "cell spec (expected %d)" % (blob.size, total))
        for name, shape, off in entries:
            n = int(np.prod(shape))
            args[name] = blob[off:off + n].reshape(shape).copy()
        return args

    def pack_weights(self, args):
        args = dict(args)
        probe = "%s%s0_i2h%s_weight" % (self._prefix, self._directions[0],
                                        self._gate_names[0])
        if probe not in args:
            return args
        entries, _ = self._blob_entries(args[probe].shape[1])
        # the entries tile the blob in offset order
        args[self._parameter.name] = concatenate(
            [args.pop(name).reshape((-1,)) for name, _, _ in entries],
            axis=0)
        return args

    @property
    def state_info(self):
        d = 2 if self._bidi else 1
        n = [{"shape": (self._num_layers * d, 0, self._num_hidden),
              "__layout__": "LNC"}]
        if self._mode == "lstm":
            n.append({"shape": (self._num_layers * d, 0, self._num_hidden),
                      "__layout__": "LNC"})
        return n

    def unroll(self, length, inputs=None, begin_state=None,
               input_prefix="", layout="NTC", merge_outputs=None):
        self.reset()
        if not isinstance(inputs, sym.Symbol):
            inputs = sym.Concat(*[sym.expand_dims(i, axis=1)
                                  for i in inputs], dim=1)
        if layout == "NTC":
            inputs = sym.transpose(inputs, axes=(1, 0, 2))  # -> TNC
        outputs = sym.RNN(inputs, self.params.get("parameters"),
                          self.params.get("state"),
                          *((self.params.get("state_cell"),)
                            if self._mode == "lstm" else ()),
                          mode=self._mode, state_size=self._num_hidden,
                          num_layers=self._num_layers,
                          bidirectional=self._bidi, p=self._dropout,
                          name=self._prefix + "rnn")
        if layout == "NTC":
            outputs = sym.transpose(outputs, axes=(1, 0, 2))
        if not merge_outputs:
            outputs = list(sym.SliceChannel(outputs, axis=layout.find("T"),
                                            num_outputs=length,
                                            squeeze_axis=True))
        return outputs, []

    def unfuse(self):
        """The equivalent SequentialRNNCell of unfused cells."""
        stack = SequentialRNNCell()
        make = {"rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
                "rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
                "lstm": lambda p: LSTMCell(self._num_hidden, p),
                "gru": lambda p: GRUCell(self._num_hidden, p)}[self._mode]
        for i in range(self._num_layers):
            stack.add(make("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i < self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      "%sl%d_drop_" % (self._prefix, i)))
        return stack
