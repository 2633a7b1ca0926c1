"""Carry parameters between the JAX package and this one.

Both packages name parameters the same way and keep the same layouts
(OHWI weights, NHWC data), so conversion is a device and dtype move:
numpy arrays (what the JAX package's ``asnumpy`` gives, keyed by name)
in, NDArrays out, and back.  ``load_params`` reads a ``.params`` file the
JAX package wrote.  ``random_params`` makes a seeded set for any graph, as
numpy arrays that either package takes.  Checkpoints need no conversion:
``model.save_checkpoint`` (and ``Module.save_checkpoint`` after training)
writes the files ``mxnet_tpu.model.load_checkpoint`` reads, and
``model.load_checkpoint`` reads the JAX package's
(tests/test_torch_train.py).  Gluon's parameters carry over by the names
``Block.save_params`` writes (the net's prefix stripped):
``gluon_params_from_numpy``, ``gluon_params_to_numpy`` and
``gluon_random_params``; a ``.params`` file either package's
``save_params`` wrote loads in the other's ``load_params``.  An RNN
cell's weights carry as the fused blob (``<prefix>parameters``, one
array like any other) or unpacked per gate (``rnn_params_from_numpy``,
``rnn_params_to_numpy``).
"""
from __future__ import annotations

import numpy as np

from .context import cpu, current_context
from . import ndarray as nd

__all__ = ["params_from_numpy", "params_to_numpy", "load_params",
           "random_params", "gluon_params_from_numpy",
           "gluon_params_to_numpy", "gluon_random_params",
           "rnn_params_from_numpy", "rnn_params_to_numpy"]


def params_from_numpy(arg_params, aux_params, device=None, dtype=None):
    """({name: array}, {name: array}) -> ({name: NDArray}, {...}) on
    ``device`` (a Context), else on ``current_context()`` (the card, or the
    innermost ``with mt.cpu():`` scope; raises without a card).  Each keeps
    its array's dtype, bfloat16 too (the JAX package's bf16 arrays reach
    numpy as ``ml_dtypes.bfloat16``; their bits are kept), unless ``dtype``
    (a torch or numpy dtype or its name, ``"bfloat16"`` too) casts them."""
    ctx = device or current_context()
    conv = lambda d: {k: nd.array(np.asarray(v), ctx=ctx, dtype=dtype)  # noqa: E731
                      for k, v in d.items()}
    return conv(arg_params), conv(aux_params or {})


def params_to_numpy(arg_params, aux_params):
    """The reverse: NDArrays -> host numpy arrays, keyed by name."""
    conv = lambda d: {k: v.asnumpy() for k, v in d.items()}  # noqa: E731
    return conv(arg_params), conv(aux_params or {})


def load_params(fname, device=None, dtype=None):
    """Read a ``prefix-%04d.params`` file (either package's) into
    (arg_params, aux_params) NDArrays on ``device``, else on
    ``current_context()``."""
    args, aux = {}, {}
    for k, v in nd.load(fname, ctx=cpu()).items():
        tp, name = k.split(":", 1)
        (args if tp == "arg" else aux)[name] = v.asnumpy()
    return params_from_numpy(args, aux, device, dtype)


def _random_arg(rng, name, shape):
    """One seeded argument: He-scaled for a weight, in [0.5, 1) for a
    BatchNorm scale, N(0, 0.1) otherwise."""
    if name.endswith("_weight"):
        fan_in = int(np.prod(shape[1:]))
        v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    elif name.endswith("_gamma"):
        v = rng.uniform(0.5, 1.0, shape)
    else:
        v = rng.standard_normal(shape) * 0.1
    return v.astype(np.float32)


def random_params(symbol, data_shapes, seed=0):
    """Seeded float32 numpy parameters for every argument and aux state of
    ``symbol`` (data and ``*_label`` inputs excluded): He-scaled weights,
    BatchNorm scales in [0.5, 1), shifts and moving means around 0 and
    moving variances in [0.5, 1.5), so that a mix-up between statistics
    changes the answer.  Returns (arg_params, aux_params)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**data_shapes)
    args = {name: _random_arg(rng, name, shape)
            for name, shape in zip(symbol.list_arguments(), arg_shapes)
            if name not in data_shapes and not name.endswith("_label")}
    aux = {}
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        v = rng.uniform(0.5, 1.5, shape) if name.endswith("_var") \
            else rng.standard_normal(shape) * 0.1
        aux[name] = v.astype(np.float32)
    return args, aux


def _stripped(net):
    """{name without the net's prefix: Parameter}, as ``save_params``
    names them."""
    return {k[len(net.prefix):]: p for k, p in net.collect_params().items()}


def gluon_params_from_numpy(net, arrays, ctx=None):
    """Set every parameter of the Gluon ``net`` from ``arrays`` ({name
    without the net's prefix: numpy array}), on ``ctx`` (else
    ``current_context()``) for a parameter not initialized yet, else into
    its own array.  Raises on a missing or an extra name."""
    params = _stripped(net)
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError("gluon_params_from_numpy: missing %s, extra %s"
                         % (missing, extra))
    for name, p in params.items():
        p._load_init(nd.array(np.asarray(arrays[name]), ctx=cpu()), ctx)


def gluon_params_to_numpy(net):
    """{name without the net's prefix: numpy array} of every parameter."""
    return {k: p.data().asnumpy() for k, p in _stripped(net).items()}


def gluon_random_params(net, data_shape, seed=0):
    """Seeded float32 numpy arrays for every parameter of the Gluon
    ``net`` at input ``data_shape`` (``random_params`` over the net's
    symbol), keyed without the net's prefix.  A net that is no
    HybridBlock (``gluon.rnn``'s fused layers) has no symbol: its arrays
    take the parameters' own shapes, each unknown (0) dimension, the
    first layer's input width, from ``data_shape``'s last axis."""
    from . import symbol
    from .gluon import HybridBlock
    if not isinstance(net, HybridBlock):
        rng = np.random.default_rng(seed)
        return {k: _random_arg(rng, k, tuple(d or data_shape[-1]
                                             for d in p.shape))
                for k, p in _stripped(net).items()}
    sym = net(symbol.var("data"))
    args, aux = random_params(sym, {"data": tuple(data_shape)}, seed)
    return {k[len(net.prefix):]: v for k, v in {**args, **aux}.items()}


def rnn_params_from_numpy(cells, arrays, device=None):
    """``arrays`` ({name: numpy array}, each cell's weights unpacked per
    gate, as the JAX package's ``unpack_weights`` gives them) ->
    {name: NDArray} on ``device`` (else ``current_context()``), each of
    ``cells``' weights packed (a fused cell's into its blob)."""
    args, _ = params_from_numpy(arrays, {}, device)
    for cell in cells if isinstance(cells, (list, tuple)) else [cells]:
        args = cell.pack_weights(args)
    return args


def rnn_params_to_numpy(cells, arg_params):
    """The reverse: each of ``cells``' weights unpacked per gate, then
    every NDArray to a host numpy array."""
    for cell in cells if isinstance(cells, (list, tuple)) else [cells]:
        arg_params = cell.unpack_weights(arg_params)
    return params_to_numpy(arg_params, {})[0]
