"""The rest of the Module API on LeNet, against the JAX package.

The net, data and weights of tests/test_torch_lenet.py: checkpoints with
optimizer states written by either package resume in the other,
``get_input_grads``, ``reshape`` (a batch of another size),
``borrow_optimizer``, ``output_shapes``, and a Monitor's stats through
``fit(monitor=)``, each within that file's RTOL (SGD: the same float32
arithmetic with sums in another order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_lenet import (BATCH, OPTIMIZERS, _close, _fit, _params,
                              lenet)  # noqa: F401 (a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_with_optimizer_states_resume_in_either_package(
        lenet, tmp_path, writer):
    """One epoch of SGD in ``writer``'s package, ``save_checkpoint(...,
    save_optimizer_states=True)`` through ``module_checkpoint``, then
    ``Module.load(..., load_optimizer_states=True)`` and one more epoch in
    each package: the two resumed runs agree."""
    jsym, tsym, args, x, y = lenet
    prefix = str(tmp_path / "lenet")
    pkg, sym = (mx, jsym) if writer == "jax" else (mt, tsym)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    _fit(pkg, sym, args, x, y, "sgd", mod=mod,
         epoch_end_callback=pkg.callback.module_checkpoint(
             mod, prefix, save_optimizer_states=True))
    resumed = {}
    for p in (mx, mt):
        m = p.mod.Module.load(prefix, 1, load_optimizer_states=True,
                              context=p.cpu())
        _, a1, _ = p.model.load_checkpoint(prefix, 1)
        m, losses = _fit(p, None, {k: v.asnumpy() for k, v in a1.items()},
                         x, y, "sgd", num_epoch=2, begin_epoch=1, mod=m)
        resumed[p] = (losses, _params(m),
                      m._updater.states[0].asnumpy())
    (jl, jp, js), (tl, tp, ts) = resumed[mx], resumed[mt]
    assert np.abs(ts).max() > 0     # the momentum was carried over
    _close(tl, jl, "losses")
    _close(ts, js, "momentum of conv1_weight")
    for k, v in tp.items():
        _close(v, jp[k], k)


def test_module_api_matches_jax(lenet):
    """``output_shapes``, ``get_input_grads`` after a training forward and
    backward, a smaller batch through ``forward`` (``reshape``), and a
    second module that ``borrow_optimizer``s the first's and updates."""
    jsym, tsym, args, x, y = lenet
    got = {}
    for pkg, sym in ((mx, jsym), (mt, tsym)):
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        mod.bind([("data", (BATCH, 1, 28, 28))],
                 [("softmax_label", (BATCH,))], inputs_need_grad=True)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in args.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=OPTIMIZERS["sgd"])
        batch = pkg.io.DataBatch([pkg.nd.array(x[:BATCH], ctx=pkg.cpu())],
                                 [pkg.nd.array(y[:BATCH], ctx=pkg.cpu())])
        mod.forward_backward(batch)
        out = {"shapes": mod.output_shapes,
               "dx": mod.get_input_grads()[0].asnumpy()}
        small = pkg.io.DataBatch([pkg.nd.array(x[:8], ctx=pkg.cpu())],
                                 [pkg.nd.array(y[:8], ctx=pkg.cpu())])
        mod.forward(small, is_train=False)
        out["small"] = mod.get_outputs()[0].asnumpy()
        out["small_shapes"] = mod.output_shapes
        other = pkg.mod.Module(sym, context=pkg.cpu())
        other.bind([("data", (BATCH, 1, 28, 28))],
                   [("softmax_label", (BATCH,))])
        other.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                      for k, v in args.items()})
        other.borrow_optimizer(mod)
        other.forward_backward(batch)
        other.update()
        out["borrowed"] = _params(other)
        out["shared_state"] = mod._updater.states[0].asnumpy()
        got[pkg] = out
    j, t = got[mx], got[mt]
    assert t["shapes"] == j["shapes"] == [("softmax_output", (BATCH, 10))]
    assert t["small_shapes"] == j["small_shapes"]
    _close(t["dx"], j["dx"], "input grads")
    _close(t["small"], j["small"], "reshaped forward")
    _close(t["shared_state"], j["shared_state"], "borrowed state")
    for k, v in t["borrowed"].items():
        _close(v, j["borrowed"][k], k)


def test_monitor_stats_match_jax(lenet):
    """``fit(monitor=Monitor(1, pattern=".*"))`` for two steps: the same
    (step, name) rows and stats in both packages."""
    jsym, tsym, args, x, y = lenet
    rows = {}
    for pkg, sym in ((mx, jsym), (mt, tsym)):
        mon = pkg.monitor.Monitor(1, pattern=".*")
        seen = []
        toc = mon.toc

        def record(toc=toc, seen=seen):
            res = toc()
            seen.extend(res)
            return res
        mon.toc = record
        _fit(pkg, sym, args, x[:2 * BATCH], y[:2 * BATCH], "sgd",
             monitor=mon)
        rows[pkg] = seen
    assert [r[:2] for r in rows[mt]] == [r[:2] for r in rows[mx]]
    assert [r[1] for r in rows[mt]] == ["softmax_output"] * 2
    _close([float(r[2]) for r in rows[mt]], [float(r[2]) for r in rows[mx]],
           "stats")
