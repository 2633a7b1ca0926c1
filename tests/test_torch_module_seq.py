"""SequentialModule, PythonModule and PythonLossModule against the JAX
package, on the CPU: the cases of tests/test_module.py (two symbolic
stages with auto-wiring and labels on the second; a symbol stage whose
head gradient is PythonLossModule's default softmax cross-entropy; two
stages naming one parameter), run from the same weights in both
packages.  Outputs within 1e-5 absolute, trained weights within 1e-4
relative L2 (float32 sums in another order).  Also the bucketed language
model's loss head where padding dominates the labels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import invoke_jax
from mxnet_tpu_torch.ops.registry import invoke

torch.set_num_threads(1)

FWD_ATOL = 1e-5
PARAM_RTOL = 1e-4


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


def _two_stage(pkg, w, x, y, steps):
    net1 = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                  name="fc1")
    net2 = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(pkg.sym.Variable("fc1_output"), num_hidden=4,
                               name="fc2"), name="softmax")
    mod1 = pkg.mod.Module(net1, label_names=None, context=pkg.cpu())
    mod2 = pkg.mod.Module(net2, data_names=("fc1_output",),
                          context=pkg.cpu())
    seq = pkg.mod.SequentialModule()
    seq.add(mod1).add(mod2, take_labels=True, auto_wiring=True)
    seq.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    seq.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in w.items()})
    seq.init_optimizer(kvstore=None, optimizer_params={"learning_rate": 0.1})
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                             label=[pkg.nd.array(y, ctx=pkg.cpu())])
    outs = []
    for _ in range(steps):
        seq.forward(batch, is_train=True)
        outs.append(seq.get_outputs()[0].asnumpy())
        seq.backward()
        seq.update()
    metric = pkg.metric.create("acc")
    seq.update_metric(metric, batch.label)
    return (outs, {k: v.asnumpy() for k, v in seq.get_params()[0].items()},
            seq.output_shapes, metric.get()[1])


def test_sequential_module_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    y = np.array([0, 1, 2, 3], np.float32)
    w = _weights({"fc1_weight": (8, 16), "fc1_bias": (8,),
                  "fc2_weight": (4, 8), "fc2_bias": (4,)}, 1)
    (to, tp, ts, ta), (jo, jp, js, ja) = [_two_stage(p, w, x, y, 3)
                                          for p in (mt, mx)]
    assert ts == js == [("softmax_output", (4, 4))] and ta == ja
    for g, want in zip(to, jo):
        np.testing.assert_allclose(g, want, rtol=0, atol=FWD_ATOL)
    assert sorted(tp) == sorted(jp) == sorted(w)
    for k in w:
        assert _rel(tp[k], jp[k]) < PARAM_RTOL, k
        assert not np.array_equal(tp[k], w[k]), k


def _loss_chain(pkg, w, x, y, steps, grad_func=None):
    net1 = pkg.sym.softmax(
        pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                               name="fc1"))
    mod1 = pkg.mod.Module(net1, label_names=None, context=pkg.cpu())
    loss = pkg.mod.PythonLossModule(data_names=("softmax_output",),
                                    grad_func=grad_func)
    seq = pkg.mod.SequentialModule()
    seq.add(mod1).add(loss, take_labels=True, auto_wiring=True)
    seq.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    seq.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in w.items()})
    seq.init_optimizer(kvstore=None)
    batch = pkg.io.DataBatch(data=[pkg.nd.array(x, ctx=pkg.cpu())],
                             label=[pkg.nd.array(y, ctx=pkg.cpu())])
    grads = []
    for _ in range(steps):
        seq.forward(batch, is_train=True)
        seq.backward()
        grads.append(loss.get_input_grads()[0].asnumpy())
        seq.update()
    return grads, mod1.get_params()[0]["fc1_weight"].asnumpy(), \
        loss.output_shapes


@pytest.mark.parametrize("custom", [False, True])
def test_python_loss_module_chain_matches_jax(custom):
    """The default gradient p - onehot(label) (or a grad_func on host
    arrays) flows into the symbol stage, five steps."""
    x = np.random.default_rng(2).random((4, 6)).astype(np.float32)
    y = np.array([0., 1., 2., 3.], np.float32)
    w = _weights({"fc1_weight": (4, 6), "fc1_bias": (4,)}, 3)

    def half_ce(scores, labels):
        p = scores.asnumpy()
        return 0.5 * (p - np.eye(p.shape[-1], dtype=p.dtype)[
            labels.asnumpy().astype(int)])
    f = half_ce if custom else None
    (tg, tw, ts), (jg, jw, js) = [_loss_chain(p, w, x, y, 5, f)
                                  for p in (mt, mx)]
    assert ts == js == [("pyloss_output", (4, 4))]
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g, want, rtol=0, atol=FWD_ATOL)
    assert _rel(tw, jw) < PARAM_RTOL
    assert np.abs(tw - w["fc1_weight"]).sum() > 1e-3


def test_duplicate_param_rejected_and_python_module_contract():
    for pkg in (mt, mx):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                     name="fc_same")
        net_b = pkg.sym.FullyConnected(pkg.sym.Variable("fc_same_output"),
                                       num_hidden=4, name="fc_same")
        m1 = pkg.mod.Module(net, label_names=None, context=pkg.cpu())
        m2 = pkg.mod.Module(net_b, data_names=("fc_same_output",),
                            label_names=None, context=pkg.cpu())
        seq = pkg.mod.SequentialModule().add(m1).add(m2, auto_wiring=True)
        seq.bind(data_shapes=[("data", (2, 4))])
        with pytest.raises(pkg.MXNetError):
            seq.init_params()
        with pytest.raises(pkg.MXNetError):
            seq.add(m1, take_label=True)
        loss = pkg.mod.PythonLossModule()
        with pytest.raises(pkg.MXNetError):
            loss.bind([("other", (2, 3))])
        loss.bind([("data", (2, 3))], [("softmax_label", (2,))])
        assert loss.get_params() == ({}, {})
        with pytest.raises(pkg.MXNetError):
            loss.backward(out_grads=[1])


def test_softmax_output_where_padding_dominates():
    """examples/rnn_ptb.py's loss head (``use_ignore``,
    ``ignore_label=0``, ``normalization="valid"``) at a bucket where 44 of
    48 labels are padding: the probabilities and the data gradient equal
    the JAX op's (1e-6 absolute), and the ignored rows get no
    gradient."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((48, 16)).astype(np.float32)
    y = np.zeros(48, np.float32)
    y[[0, 7, 8, 30]] = [3, 5, 1, 15]
    attrs = {"use_ignore": True, "ignore_label": 0,
             "normalization": "valid"}
    want, vjp = jax.vjp(lambda d: invoke_jax("SoftmaxOutput", attrs, d,
                                             jnp.asarray(y),
                                             training=True)[0],
                        jnp.asarray(x))
    (jgrad,) = vjp(jnp.ones_like(want))
    xt = torch.from_numpy(x).requires_grad_()
    got = invoke("SoftmaxOutput", attrs, xt, torch.from_numpy(y),
                 training=True)[0]
    got.backward(torch.ones_like(got))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)
    assert not xt.grad.numpy()[y == 0].any()
