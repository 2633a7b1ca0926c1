"""Gluon recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: RecurrentCell
(``state_info``, ``begin_state``, ``unroll`` with ``valid_length``
masking through SequenceMask and SequenceLast), HybridRecurrentCell
(``hybridize()`` runs each step through a ``CachedOp``), RNNCell,
LSTMCell, GRUCell, SequentialRNNCell, DropoutCell, ModifierCell,
ZoneoutCell, ResidualCell and BidirectionalCell.  An unroll runs one step
after another, each op eagerly; ``gluon.rnn.LSTM`` and its kin run the
whole sequence through the fused ``RNN`` op instead.
"""
from __future__ import annotations

from ... import ndarray, symbol
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        if F is ndarray:
            ctx = inputs.context if isinstance(inputs, ndarray.NDArray) \
                else inputs[0].context
            with ctx:
                begin_state = cell.begin_state(func=ndarray.zeros,
                                               batch_size=batch_size)
        else:
            begin_state = cell.begin_state(func=symbol.zeros,
                                           batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    assert inputs is not None, \
        "unroll needs explicit inputs (inputs=None is not supported); " \
        "build the input variables before calling unroll"

    axis = layout.find("T")
    batch_axis = layout.find("N")
    batch_size = 0
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        F = symbol
        if merge is False:
            assert len(inputs.list_outputs()) == 1, \
                "cannot unroll a grouped Symbol: pass list(inputs), or a " \
                "single-output Symbol for unroll to split along time"
            inputs = list(symbol.split(inputs, axis=in_axis,
                                       num_outputs=length, squeeze_axis=1))
    elif isinstance(inputs, ndarray.NDArray):
        F = ndarray
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[in_axis]
            steps = ndarray.invoke(
                "SliceChannel", [inputs],
                {"axis": in_axis, "num_outputs": inputs.shape[in_axis],
                 "squeeze_axis": False})
            if isinstance(steps, ndarray.NDArray):
                steps = [steps]
            inputs = [x.reshape([y for i, y in enumerate(x.shape)
                                 if i != in_axis]) for x in steps]
    else:
        assert length is None or len(inputs) == length
        if isinstance(inputs[0], symbol.Symbol):
            F = symbol
        else:
            F = ndarray
            batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = F.stack(*[F.expand_dims(i, axis=axis) for i in inputs],
                             num_args=len(inputs)) if F is symbol else \
                ndarray.invoke("stack", list(inputs), {"axis": axis})
            in_axis = axis
    if isinstance(inputs, (symbol.Symbol, ndarray.NDArray)) \
            and axis != in_axis:
        inputs = F.swapaxes(inputs, dim1=axis, dim2=in_axis) \
            if F is symbol else inputs.swapaxes(in_axis, axis)
    return inputs, axis, F, batch_size


def _mask_sequence_variable_length(F, data, length, valid_length, time_axis,
                                   merge):
    assert valid_length is not None
    if not isinstance(data, (list, tuple)):
        data = list(data)
    outputs = F.SequenceMask(F.stack(*data, num_args=len(data)) if F is symbol
                             else ndarray.invoke("stack", list(data),
                                                 {"axis": 0}),
                             sequence_length=valid_length,
                             use_sequence_length=True, axis=0)
    if not merge:
        outputs = list(F.split(outputs, num_outputs=len(data), axis=0,
                               squeeze_axis=True)) if F is symbol else \
            [outputs[i] for i in range(len(data))]
    return outputs


class RecurrentCell(Block):
    """Abstract recurrent cell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset before re-using the cell for another graph."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children:
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states."""
        assert not self._modified, \
            "this cell is wrapped by a modifier (e.g. ZoneoutCell); " \
            "invoke the modifier, not the base cell"
        if func is None:
            func = ndarray.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name="%sbegin_state_%d" % (self._prefix,
                                                    self._init_counter),
                         **info) if func is symbol.zeros else \
                func(shape=info["shape"])
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell for `length` timesteps."""
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs, layout,
                                                       False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [F.SequenceLast(
                ndarray.invoke("stack", [st[i] for st in all_states],
                               {"axis": 0}) if F is ndarray else
                F.stack(*[st[i] for st in all_states], num_args=length),
                sequence_length=valid_length, use_sequence_length=True,
                axis=0) for i in range(len(states))]
            outputs = _mask_sequence_variable_length(F, outputs, length,
                                                     valid_length, axis, True)
            outputs, _, _, _ = _format_sequence(length, outputs, "TNC",
                                                merge_outputs)
        else:
            outputs, _, _, _ = _format_sequence(length, outputs, "TNC",
                                                merge_outputs)
            if merge_outputs and layout.find("T") != 0 and \
                    isinstance(outputs, (ndarray.NDArray, symbol.Symbol)):
                outputs = outputs.swapaxes(0, layout.find("T")) \
                    if F is ndarray else F.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """RecurrentCell with hybrid_forward."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """Elman RNN cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size,
                               name=prefix + "h2h")
        output = self._get_activation(F, i2h + h2h, self._activation,
                                      name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell, gate order [i, f, c, o]."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(4 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(4 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 4,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 4,
                               name=prefix + "h2h")
        gates = i2h + h2h
        slice_gates = F.SliceChannel(gates, num_outputs=4,
                                     name=prefix + "slice")
        in_gate = F.Activation(slice_gates[0], act_type="sigmoid",
                               name=prefix + "i")
        forget_gate = F.Activation(slice_gates[1], act_type="sigmoid",
                                   name=prefix + "f")
        in_transform = F.Activation(slice_gates[2], act_type="tanh",
                                    name=prefix + "c")
        out_gate = F.Activation(slice_gates[3], act_type="sigmoid",
                                name=prefix + "o")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type="tanh",
                                         name=prefix + "state")
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell, gate order [r, z, n] (cuDNN variant)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get("i2h_weight",
                                          shape=(3 * hidden_size, input_size),
                                          init=i2h_weight_initializer,
                                          allow_deferred_init=True)
        self.h2h_weight = self.params.get("h2h_weight",
                                          shape=(3 * hidden_size, hidden_size),
                                          init=h2h_weight_initializer,
                                          allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer,
                                        allow_deferred_init=True)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer,
                                        allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 3,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 3,
                               name=prefix + "h2h")
        i2h_r, i2h_z, i2h = F.SliceChannel(i2h, num_outputs=3,
                                           name=prefix + "i2h_slice")
        h2h_r, h2h_z, h2h = F.SliceChannel(h2h, num_outputs=3,
                                           name=prefix + "h2h_slice")
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name=prefix + "r_act")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name=prefix + "z_act")
        next_h_tmp = F.Activation(i2h + reset_gate * h2h, act_type="tanh",
                                  name=prefix + "h_act")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Sequentially stacking multiple cells."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        num_cells = len(self._children)
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    None)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on cell inputs."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float), "rate must be a number"
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate,
                               name="t%d_fwd" % self._counter)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, (ndarray.NDArray, symbol.Symbol)):
            return self.hybrid_forward(F, inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base for cells that modify another cell."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "cell %s already has a modifier attached; a cell takes at " \
            "most one" % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "zoneout cannot wrap a BidirectionalCell (it has no per-step " \
            "call); wrap the inner cells instead"
        assert not isinstance(base_cell, SequentialRNNCell) or \
            not getattr(base_cell, "_bidirectional", False), \
            "zoneout cannot wrap a bidirectional SequentialRNNCell; wrap " \
            "the inner cells instead"
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: F.Dropout(
            F.ones_like(like) if hasattr(F, "ones_like") else like * 0 + 1,
            p=p))

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0. else next_output)
        states = ([F.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0. else next_states)
        self._prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds residual connection."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True

        merge_outputs = isinstance(outputs, (ndarray.NDArray, symbol.Symbol)) \
            if merge_outputs is None else merge_outputs
        inputs, axis, F, _ = _format_sequence(length, inputs, layout,
                                              merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [i + j for i, j in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Bidirectional wrapper over two cells."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=merge_outputs,
            valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False, valid_length=None)
        if isinstance(r_outputs, list):
            r_outputs = list(reversed(r_outputs))
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs,
                                       (ndarray.NDArray, symbol.Symbol))
            l_outputs, _, _, _ = _format_sequence(None, l_outputs, layout,
                                                  merge_outputs)
            r_outputs, _, _, _ = _format_sequence(None, r_outputs, layout,
                                                  merge_outputs)
        if merge_outputs:
            if isinstance(r_outputs, list):
                r_outputs = ndarray.invoke("stack", r_outputs,
                                           {"axis": axis}) \
                    if F is ndarray else F.stack(*r_outputs, num_args=length)
            outputs = F.Concat(l_outputs, r_outputs, dim=2) \
                if F is symbol else \
                ndarray.invoke("Concat", [l_outputs, r_outputs], {"dim": 2})
        else:
            outputs = [F.Concat(l_o, r_o, dim=1) if F is symbol else
                       ndarray.invoke("Concat", [l_o, r_o], {"dim": 1})
                       for l_o, r_o in zip(l_outputs, r_outputs)]
        if valid_length is not None:
            outputs = _mask_sequence_variable_length(F, outputs, length,
                                                     valid_length, axis,
                                                     merge_outputs)
        states = l_states + r_states
        return outputs, states
