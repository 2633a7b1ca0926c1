"""Gluon's fused RNN layers: RNN, LSTM and GRU over whole sequences.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``.  Each layer and
direction keeps its own i2h/h2h weights and biases as Parameters; every
call packs them, in the fused op's order, into the flat ``parameters``
argument of the ``RNN`` op (``ops/rnn.py``), so under ``autograd.record()``
the gradients flow back to each Parameter.  As in the reference, the
layers are Blocks, not HybridBlocks: ``hybridize()`` leaves them eager.
"""
from __future__ import annotations

from ... import ndarray
from ...ndarray import NDArray
from ..block import Block
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(Block):
    """Base fused-sequence RNN layer."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(shape[1] if shape[1] else None,
                                      shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _unfuse(self):
        """This layer as a stack of unfused cells."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.SequentialRNNCell(prefix=self.prefix,
                                           params=self.collect_params())
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {"input_size": ni,
                          "i2h_weight_initializer":
                              self._i2h_weight_initializer,
                          "h2h_weight_initializer":
                              self._h2h_weight_initializer,
                          "i2h_bias_initializer": self._i2h_bias_initializer,
                          "h2h_bias_initializer": self._h2h_bias_initializer}
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix="l%d_" % i, **kwargs),
                        get_cell(prefix="r%d_" % i, **kwargs)))
                else:
                    stack.add(get_cell(prefix="l%d_" % i, **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if func is None:
            func = ndarray.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(shape=info["shape"], **{k: v for k, v in
                                                       kwargs.items()
                                                       if k != "shape"}))
        return states

    def forward(self, inputs, states=None):
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        if self._input_size == 0:
            for i in (["l", "r"] if self._dir == 2 else ["l"]):
                p = getattr(self, "{}0_i2h_weight".format(i))
                if p.shape[1] == 0:
                    p.shape = (p.shape[0], inputs.shape[-1])
                    p._finish_deferred_init()
            self._input_size = inputs.shape[-1]
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _ordered_params(self):
        """The parameters in the packed blob's order (``ops/rnn.py``):
        weights (i2h, h2h per layer and direction), then biases."""
        args = []
        dirs = ["l", "r"] if self._dir == 2 else ["l"]
        for kinds in (("i2h_weight", "h2h_weight"), ("i2h_bias", "h2h_bias")):
            for i in range(self._num_layers):
                for j in dirs:
                    for kind in kinds:
                        args.append(getattr(
                            self, "%s%d_%s" % (j, i, kind)).data())
        return args

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        params = self._ordered_params()
        flat = ndarray.invoke(
            "Concat", [p.reshape((-1,)) for p in params], {"dim": 0})
        rnn_args = [inputs, flat] + list(states)
        outs = ndarray.invoke("RNN", rnn_args, {
            "state_size": self._hidden_size, "num_layers": self._num_layers,
            "bidirectional": self._dir == 2, "p": self._dropout,
            "state_outputs": True, "mode": self._mode})
        if self._mode == "lstm":
            outputs, states = outs[0], [outs[1], outs[2]]
        else:
            outputs, states = outs[0], [outs[1]]
        if self._layout == "NTC":
            outputs = outputs.swapaxes(0, 1)
        return outputs, states


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (relu or tanh)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
