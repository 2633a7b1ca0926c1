"""NDArray: a thin handle over a ``torch.Tensor`` on a context.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``: creation (``array``,
``zeros``, ``ones``, ``full``, ``empty``, ``arange``, the ``*_like``
forms), ``asnumpy``, ``asscalar``, ``astype``, ``as_in_context``,
``copyto``, ``copy``, ``detach``, ``reshape``, indexing and assignment
(recorded under ``autograd.record()``), shape, size, ndim and dtype, the
arithmetic, comparison and in-place operators, the SGD updates (plain and
multi-precision) and the other update ops (Adam, RMSProp, Ftrl,
SignSGD, Signum) with ``out=`` (in place, as the reference writes them),
``attach_grad`` / ``grad`` / ``backward`` for ``autograd``, and
``invoke``, the imperative dispatch that every generated ``mt.nd.<op>``
calls.  The generated methods (``x.sum()``, ``x.log_softmax()``, ...) are
attached by ``register.attach_methods``.

An array made without ``ctx`` (``array``, ``zeros``, an op without array
inputs) lands on ``current_context()``: the innermost ``with ctx:``
scope, else the first card.  ``invoke`` runs the op eagerly on its
inputs' device; while ``autograd.is_recording()`` it runs with torch's
gradient recording on, so the result carries its graph, and mode-dependent
ops see ``training=autograd.is_training()``.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ops.registry import OpDef, get_op, torch_dtype, dtype_name

__all__ = ["NDArray", "array", "from_numpy", "zeros", "zeros_like", "ones",
           "ones_like", "full", "empty", "arange", "concatenate", "waitall",
           "invoke", "sgd_update", "sgd_mom_update", "mp_sgd_update",
           "mp_sgd_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "signsgd_update",
           "signum_update"]


def _ctx_of(c):
    """A Context from a Context or its string form (``"gpu(0)"``)."""
    if c is None or isinstance(c, Context):
        return c
    dt, rest = str(c).split("(", 1)
    return Context(dt, int(rest.rstrip(")")))


def invoke(op, inputs, attrs=None, out=None):
    """Run op ``op`` (a name or an OpDef) on NDArrays ``inputs`` with
    ``attrs`` (normalized by the OpDef); returns its visible output(s), or
    writes them into ``out`` (in place when autograd is not recording and
    the buffer fits; else the handle takes the result).  Aux inputs an op
    updates (BatchNorm's moving statistics) are updated in place, with
    nothing recorded (``write_aux``).  The device is the inputs', else the
    ``ctx`` attr, else ``current_context()``; an op without array inputs
    is told it in its ``ctx`` attr."""
    from .. import autograd
    opdef = op if isinstance(op, OpDef) else get_op(op)
    attrs = dict(attrs or {})
    ctx = _ctx_of(attrs.pop("ctx", None))
    for i in inputs:
        if isinstance(i, NDArray):
            ctx = i.context
            break
    if ctx is None:
        ctx = current_context()
    if not inputs and "ctx" in opdef.params:
        attrs["ctx"] = str(ctx)
    if opdef.variable_inputs and opdef.key_var_num_args:
        attrs.setdefault(opdef.key_var_num_args, len(inputs))
    attrs = opdef.normalize(attrs)
    tensors = []
    for i in inputs:
        if not isinstance(i, NDArray):
            raise MXNetError("%s: inputs must be NDArrays, got %s"
                             % (opdef.name, type(i).__name__))
        tensors.append(i._data)
    recording = autograd.is_recording()
    training = autograd.is_training()
    if not training:
        # an in-place op (a KV-cache write) works on a copy: an imperative
        # call never changes its inputs
        for k in opdef.inplace:
            tensors[k] = tensors[k].clone()
    with torch.set_grad_enabled(recording):
        outs = opdef.bound(attrs, training)(*tensors)
    if not inputs:
        outs = tuple(o.to(ctx.device) for o in outs)
    for in_idx, out_idx in opdef.mutate_aux.items():
        if in_idx < len(inputs):
            write_aux(inputs[in_idx], outs[out_idx])
    nvis = opdef.num_visible_outputs
    if callable(nvis):
        nvis = nvis(attrs)
    vis = [NDArray(o) for o in outs[:nvis]]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        for t, v in zip(targets, vis):
            t._assign(v._data, recording)
        return out
    if nvis == 0:
        return None
    return vis[0] if nvis == 1 else vis


def write_aux(arr, tensor):
    """An op's new aux state (BatchNorm's moving statistics) into ``arr``:
    copied into its tensor in place, recording nothing, so every holder
    of ``arr`` sees it; taken as a new tensor only where it cannot fit (a
    new shape, dtype or device).  ``ndarray.invoke`` and ``CachedOp``
    write aux states this way."""
    t = arr._data
    if tensor is t:
        return
    if t.shape == tensor.shape and t.dtype == tensor.dtype \
            and t.device == tensor.device:
        with torch.no_grad():
            t.copy_(tensor)
    else:
        arr._data = tensor.detach()


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, tensor):
        self._data = tensor
        self._grad = None
        self._grad_req = "null"

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return Context.of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return invoke("transpose", [self])

    @property
    def grad(self):
        """The gradient buffer ``attach_grad`` made, filled by
        ``autograd.backward``."""
        return self._grad

    def attach_grad(self, grad_req="write"):
        """Make this array an autograd variable with a zero gradient
        buffer; ``grad_req`` is write, add or null."""
        from .. import autograd
        autograd.mark_variables([self], [NDArray(torch.zeros_like(
            self._data.detach()))], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def _assign(self, tensor, recording=False):
        """Write ``tensor`` into this array: in place when it fits, nothing
        is being recorded and the array is no recorded result (a variable's
        leaf stays the same tensor, so it keeps its gradient); else by
        taking the tensor, which is what a recorded assignment needs."""
        t = self._data
        if not recording and (t.is_leaf or not t.requires_grad) \
                and t.shape == tensor.shape and t.dtype == tensor.dtype \
                and t.device == tensor.device:
            with torch.no_grad():
                t.copy_(tensor)
        else:
            self._data = tensor

    @staticmethod
    def _key(key):
        """An NDArray in an index is taken as integer indices."""
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, tuple):
            return tuple(NDArray._key(k) for k in key)
        return key

    def __getitem__(self, key):
        """``self[key]``; recorded under ``autograd.record()``."""
        from .. import autograd
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[self._key(key)])

    def __setitem__(self, key, value):
        """Write a scalar, a numpy array, a tensor or an NDArray into
        ``self[key]``, cast to this array's dtype and moved to its
        device.  Under ``autograd.record()``, where the array or the value
        carries a recorded gradient, the write is recorded: the array takes
        a new tensor with the slice replaced."""
        from .. import autograd
        key = self._key(key)
        if autograd.is_recording() and (
                self._data.requires_grad or (isinstance(value, NDArray)
                                             and value._data.requires_grad)):
            new = self._data.clone()
            new[key] = value._data if isinstance(value, NDArray) else value
            self._data = new
            return
        with torch.no_grad():
            if isinstance(value, (int, float)):
                self._data[key] = value
                return
            if isinstance(value, NDArray):
                src = value._data
            elif isinstance(value, torch.Tensor):
                src = value
            else:
                src = _host_tensor(value)
            self._data[key].copy_(src)

    def copy(self):
        """A copy (recorded under ``autograd.record()``)."""
        return invoke("_copy", [self])

    def detach(self):
        """This array's data outside every recorded graph."""
        return NDArray(self._data.detach())

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def astype(self, dtype, copy=True):
        """A copy in ``dtype`` (recorded); this array itself when it
        already has it and ``copy`` is False."""
        if not copy and torch_dtype(dtype) == self.dtype:
            return self
        return invoke("Cast", [self], {"dtype": dtype_name(dtype)})

    def reshape(self, *shape, **kwargs):
        """A reshape with MXNet's codes (0, -1, -2, -3, -4)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.pop("shape", shape)
        return invoke("Reshape", [self], {"shape": tuple(shape), **kwargs})

    def reshape_like(self, other):
        return invoke("reshape_like", [self, other])

    def broadcast_to(self, shape):
        cur, tgt = self.shape, tuple(shape)
        me = self.reshape((1,) * (len(tgt) - len(cur)) + cur) \
            if len(cur) < len(tgt) else self
        return invoke("broadcast_to", [me], {"shape": tgt})

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __int__(self):
        return int(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def asnumpy(self):
        """A host copy: later in-place updates of this array (an
        optimizer step) do not show through it."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def copyto(self, other):
        """Copy into another NDArray (in place, keeping its device and
        dtype) or onto a context (a new NDArray)."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.device, copy=True))
        raise TypeError("copyto does not support type %s" % type(other))

    def as_in_context(self, context):
        if context == self.context:
            return self
        return self.copyto(context)

    # -- arithmetic: the reference's operators, through invoke ------------
    def _binary(self, other, op, scalar_op, reverse_scalar_op=None,
                reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(op, [a, b])
        if isinstance(other, (numbers.Number, np.number)):
            name = reverse_scalar_op if reverse else scalar_op
            return invoke(name, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar",
                            "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar",
                            "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar",
                            "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar",
                            "_rpow_scalar", reverse=True)

    def __neg__(self):
        return invoke("negative", [self])

    def __abs__(self):
        return invoke("abs", [self])

    def __eq__(self, o):
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # -- in place: written into this array's tensor outside a recording
    # (a variable keeps its leaf), taken as the new tensor inside one
    def _inplace(self, result):
        from .. import autograd
        if result is NotImplemented:
            return result
        self._assign(result._data, autograd.is_recording())
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)


def _host_tensor(a):
    """A CPU tensor over numpy array ``a``.  bfloat16 (``ml_dtypes``'
    type, in which the JAX package's bf16 arrays reach numpy, and which
    ``torch.from_numpy`` rejects) goes through its uint16 bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        # torch shares the buffer, which it may write: copy a read-only
        # one (the JAX package's arrays)
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def array(source, ctx=None, dtype=None):
    """NDArray from an NDArray (keeping its dtype), a numpy array or
    anything numpy can take, on ``ctx``, else on ``current_context()``;
    float64 input becomes float32, as in the reference, and ``dtype`` (a
    torch or numpy dtype or its name, ``"bfloat16"`` too) casts.  Always a
    copy, as in the reference: an in-place update of the NDArray never
    writes into the source."""
    if isinstance(source, NDArray):
        t = source._data.detach()
    else:
        a = np.asarray(source)
        if dtype is None and a.dtype == np.float64:
            dtype = np.float32
        t = _host_tensor(a)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t.to((ctx or current_context()).device, copy=True))


def from_numpy(arr, zero_copy=True):
    """A CPU NDArray of the host numpy array ``arr``, whatever the current
    context.  It shares ``arr``'s memory where it can (C-contiguous,
    writable, not float64), so the caller must not change ``arr``
    afterwards: the data pipeline's produce-once batch buffers.
    Otherwise, or with ``zero_copy=False``, it is a copy, as
    ``array(arr, ctx=cpu())`` makes."""
    if zero_copy and isinstance(arr, np.ndarray) \
            and arr.flags.c_contiguous and arr.flags.writeable \
            and arr.dtype != np.float64 and arr.dtype.name != "bfloat16":
        return NDArray(torch.from_numpy(arr))
    return array(arr, ctx=Context("cpu", 0))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    """Zeros on ``ctx``, else on ``current_context()``."""
    return NDArray(torch.zeros(_shape(shape),
                               dtype=torch_dtype(dtype or np.float32),
                               device=(ctx or current_context()).device))


def ones(shape, ctx=None, dtype=None, **kwargs):
    """Ones on ``ctx``, else on ``current_context()``."""
    return NDArray(torch.ones(_shape(shape),
                              dtype=torch_dtype(dtype or np.float32),
                              device=(ctx or current_context()).device))


def full(shape, val, ctx=None, dtype=None, out=None):
    """``val`` everywhere, on ``ctx``, else on ``current_context()``; into
    ``out`` when given."""
    arr = NDArray(torch.full(_shape(shape), float(val),
                             dtype=torch_dtype(dtype or np.float32),
                             device=(ctx or current_context()).device))
    if out is None:
        return arr
    out._assign(arr._data)
    return out


def empty(shape, ctx=None, dtype=None):
    """An array of ``shape`` (zeros, as the reference's)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``_arange`` on ``ctx``, else on ``current_context()``."""
    return invoke("_arange", [], {
        "start": float(start), "stop": None if stop is None else float(stop),
        "step": float(step), "repeat": int(repeat),
        "dtype": np.dtype(dtype or np.float32).name,
        "ctx": ctx or current_context()})


def zeros_like(arr):
    return NDArray(torch.zeros_like(arr._data.detach()))


def ones_like(arr):
    return NDArray(torch.ones_like(arr._data.detach()))


def concatenate(arrays, axis=0, always_copy=True):
    return invoke("Concat", list(arrays), {"dim": axis})


def waitall():
    """Wait for every queued operation of every card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _update_target(weight, out):
    if out is None:
        return weight.copy()
    if out is not weight:
        weight.copyto(out)
    return out


def sgd_update(weight, grad, out=None, **attrs):
    """``ops.optimizer_ops.sgd_update`` into ``out`` (a copy of weight
    when None; ``out=weight`` updates in place)."""
    from ..ops.optimizer_ops import sgd_update as update
    out = _update_target(weight, out)
    update(out._data, grad._data, **attrs)
    return out


def sgd_mom_update(weight, grad, mom, out=None, **attrs):
    """``ops.optimizer_ops.sgd_mom_update`` into ``out``; the momentum
    ``mom`` is updated in place."""
    from ..ops.optimizer_ops import sgd_mom_update as update
    out = _update_target(weight, out)
    update(out._data, grad._data, mom._data, **attrs)
    return out


def mp_sgd_update(weight, grad, weight32, out=None, **attrs):
    """``ops.optimizer_ops.mp_sgd_update`` into ``out``; the f32 master
    copy ``weight32`` is updated in place."""
    from ..ops.optimizer_ops import mp_sgd_update as update
    out = _update_target(weight, out)
    update(out._data, grad._data, weight32._data, **attrs)
    return out


def mp_sgd_mom_update(weight, grad, mom, weight32, out=None, **attrs):
    """``ops.optimizer_ops.mp_sgd_mom_update`` into ``out``; the f32
    momentum ``mom`` and master copy ``weight32`` are updated in place."""
    from ..ops.optimizer_ops import mp_sgd_mom_update as update
    out = _update_target(weight, out)
    update(out._data, grad._data, mom._data, weight32._data, **attrs)
    return out


def _state_update(name):
    """``nd.<name>(weight, grad, *states, out=None, **attrs)``: the
    in-place ``ops.optimizer_ops.<name>`` into ``out`` (a copy of weight
    when None; ``out=weight`` updates in place), the states updated in
    place."""
    def fn(weight, grad, *states, out=None, **attrs):
        from ..ops import optimizer_ops
        out = _update_target(weight, out)
        getattr(optimizer_ops, name)(out._data, grad._data,
                                     *[st._data for st in states], **attrs)
        return out
    fn.__name__ = name
    return fn


adam_update = _state_update("adam_update")
rmsprop_update = _state_update("rmsprop_update")
rmspropalex_update = _state_update("rmspropalex_update")
ftrl_update = _state_update("ftrl_update")
signsgd_update = _state_update("signsgd_update")
signum_update = _state_update("signum_update")
