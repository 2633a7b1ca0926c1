"""Testing utilities: tolerance asserts and gradient checks through the
symbol executor.

Counterpart of ``mxnet_tpu/test_utils.py`` (``assert_almost_equal``,
``check_numeric_gradient``, ``check_symbolic_forward``,
``check_symbolic_backward``), copied because the port imports nothing of
the JAX package.  Every checker takes its context as ``ctx`` and, like
every entry point, defaults to ``current_context()``: the card, unless a
``with cpu():`` scope says otherwise.
"""
from __future__ import annotations

import numpy as np

from .context import current_context
from . import ndarray as nd

__all__ = ["default_context", "assert_almost_equal", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward"]

_DTYPE_RTOL = {np.dtype(np.float16): 1e-2, np.dtype(np.float32): 1e-4,
               np.dtype(np.float64): 1e-6, "bfloat16": 1e-2}
_DTYPE_ATOL = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5, "bfloat16": 1e-1}


def default_context():
    """The context checks run on: ``current_context()``."""
    return current_context()


def _as_np(x):
    if isinstance(x, nd.NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _dtype_tol(dtype, table):
    d = np.dtype(dtype) if str(dtype) != "bfloat16" else "bfloat16"
    return table.get(d, 1e-5)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Relative plus absolute tolerance assert, the tolerances by dtype
    when not given."""
    a, b = _as_np(a), _as_np(b)
    if rtol is None:
        rtol = max(_dtype_tol(a.dtype, _DTYPE_RTOL),
                   _dtype_tol(b.dtype, _DTYPE_RTOL))
    if atol is None:
        atol = max(_dtype_tol(a.dtype, _DTYPE_ATOL),
                   _dtype_tol(b.dtype, _DTYPE_ATOL))
    if a.shape != b.shape:
        raise AssertionError("shape mismatch: %s.shape=%s vs %s.shape=%s"
                             % (names[0], a.shape, names[1], b.shape))
    af, bf = a.astype(np.float64), b.astype(np.float64)
    with np.errstate(invalid="ignore"):
        ok = np.isclose(af, bf, rtol=rtol, atol=atol, equal_nan=equal_nan)
    if ok.all():
        return
    bad = ~ok
    idx = tuple(int(i[0]) for i in np.nonzero(bad))
    rel = np.abs(af - bf) / (np.abs(bf) + atol)
    raise AssertionError(
        "%s and %s differ at %d/%d positions (rtol=%g atol=%g); worst at "
        "%s: %r vs %r (max rel err %g)"
        % (names[0], names[1], int(bad.sum()), bad.size, rtol, atol, idx,
           af[idx], bf[idx], float(np.nanmax(rel[bad]))))


def _bind_args(sym, location, aux_states, ctx):
    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    args = {k: nd.array(np.asarray(v), ctx=ctx) for k, v in location.items()}
    aux = {k: nd.array(np.asarray(v), ctx=ctx)
           for k, v in (aux_states or {}).items()}
    return args, aux


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-4,
                           rtol=1e-2, atol=None, grad_nodes=None, ctx=None):
    """``Executor.backward``'s gradients of the outputs, each weighted by a
    fixed random projection, against central differences of the same
    weighted sum.  ``location``: argument name -> numpy array (or a list
    in argument order)."""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(location, (list, tuple)):
        location = dict(zip(arg_names, location))
    location = {k: np.array(v, np.float32) for k, v in location.items()}
    aux_states = {k: np.array(v, np.float32)
                  for k, v in (aux_states or {}).items()}
    if grad_nodes is None:
        grad_nodes = [n for n in arg_names
                      if np.issubdtype(location[n].dtype, np.floating)]
    args, aux = _bind_args(sym, location, aux_states, ctx)
    grad_req = {n: ("write" if n in grad_nodes else "null")
                for n in arg_names}
    exe = sym.bind(ctx, args=args, aux_states=aux or None,
                   grad_req=grad_req)
    outs = exe.forward(is_train=True)
    rng = np.random.default_rng(0)
    proj = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    exe.backward(out_grads=[nd.array(p, ctx=ctx) for p in proj])
    analytic = {n: exe.grad_dict[n].asnumpy().astype(np.float64)
                for n in grad_nodes}

    def fwd_scalar():
        outs = exe.forward(is_train=True)
        return sum(float((o.asnumpy().astype(np.float64) * p).sum())
                   for o, p in zip(outs, proj))

    for n in grad_nodes:
        base = location[n]
        num = np.zeros(base.shape, dtype=np.float64).reshape(-1)
        flat = base.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            h = numeric_eps * max(1.0, abs(orig))
            flat[j] = orig + h
            exe.arg_dict[n][:] = base
            fp = fwd_scalar()
            flat[j] = orig - h
            exe.arg_dict[n][:] = base
            fm = fwd_scalar()
            flat[j] = orig
            exe.arg_dict[n][:] = base
            num[j] = (fp - fm) / (2 * h)
        assert_almost_equal(analytic[n], num.reshape(base.shape),
                            rtol=rtol, atol=atol if atol is not None
                            else 1e-3,
                            names=("symbolic[%s]" % n, "numeric"))


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-5,
                           aux_states=None, ctx=None):
    """Forward outputs against expected numpy arrays."""
    ctx = ctx or default_context()
    args, aux = _bind_args(sym, location, aux_states, ctx)
    exe = sym.bind(ctx, args=args, aux_states=aux or None,
                   grad_req={n: "null" for n in sym.list_arguments()})
    outs = exe.forward(is_train=False)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    for o, e in zip(outs, expected):
        assert_almost_equal(o, e, rtol=rtol, atol=atol,
                            names=("forward", "expected"))
    return outs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-5, aux_states=None, grad_req="write",
                            ctx=None):
    """Gradients after a training forward and ``backward(out_grads)``
    against expected numpy arrays (a dict by argument name, or a list in
    argument order)."""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(arg_names, expected))
    args, aux = _bind_args(sym, location, aux_states, ctx)
    req = {n: (grad_req if n in expected else "null") for n in arg_names} \
        if isinstance(grad_req, str) else grad_req
    exe = sym.bind(ctx, args=args, aux_states=aux or None, grad_req=req)
    exe.forward(is_train=True)
    exe.backward(out_grads=[nd.array(np.asarray(g), ctx=ctx)
                            for g in out_grads])
    for n, e in expected.items():
        assert_almost_equal(exe.grad_dict[n], e, rtol=rtol, atol=atol,
                            names=("grad[%s]" % n, "expected"))
