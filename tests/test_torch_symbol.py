"""Symbols and checkpoints of the PyTorch port interchange with the JAX
package's: the same builder gives the same JSON, each package loads the
other's ``-symbol.json`` and ``.params``, and shape inference agrees."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu.models.resnet import get_resnet_symbol as jax_resnet
from mxnet_tpu.models.resnet import _resnet as jax_small_resnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.resnet import get_resnet_symbol as port_resnet
from mxnet_tpu_torch.models.resnet import _resnet as port_small_resnet

# Small CPU cases: one torch thread runs them faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

R50 = dict(num_layers=50, image_shape=(3, 224, 224), layout="NHWC",
           unit_impl="fused")
SMALL = (([2, 2], 2, [16, 32, 64], 10, (3, 64, 64), True),
         dict(layout="NHWC", unit_impl="fused"))


def _built_fresh(builder, *args, **kwargs):
    """Unnamed nodes (the pooling and flatten layers) take their names
    from a per-thread counter in each package; build under fresh counters
    so that both packages start from 0."""
    with mj.base.NameManager(), mt.base.NameManager():
        return builder(*args, **kwargs)


@pytest.fixture(scope="module")
def r50():
    return _built_fresh(jax_resnet, **R50), _built_fresh(port_resnet, **R50)


def test_resnet50_fused_json_matches_jax(r50):
    jsym, tsym = r50
    assert tsym.tojson() == jsym.tojson()
    assert tsym.tojson().count('"_contrib_FusedBottleneckUnit"') == 12


def test_load_json_round_trips_between_packages(r50):
    jsym, tsym = r50
    js = jsym.tojson()
    assert mt.sym.load_json(js).tojson() == js
    assert mj.sym.load_json(tsym.tojson()).tojson() == js
    loaded = mt.sym.load_json(js)
    assert loaded.list_arguments() == jsym.list_arguments()
    assert loaded.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert loaded.list_outputs() == jsym.list_outputs()


def test_infer_shape_matches_jax(r50):
    jsym, tsym = r50
    shapes = {"data": (2, 224, 224, 3)}
    ours = tsym.infer_shape(**shapes)
    ref = jsym.infer_shape(**shapes)
    assert [list(map(tuple, s)) for s in ours] == \
        [list(map(tuple, s)) for s in ref]
    assert ours[1] == [(2, 1000)]


def _small_params():
    tsym = _built_fresh(port_small_resnet, *SMALL[0], **SMALL[1])
    return tsym, mt.convert.random_params(tsym, {"data": (1, 64, 64, 3)},
                                          seed=3)


def _assert_same_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k], err_msg=k)


def test_jax_checkpoint_loads_in_port(tmp_path):
    tsym, (args, aux) = _small_params()
    jsym = _built_fresh(jax_small_resnet, *SMALL[0], **SMALL[1])
    prefix = str(tmp_path / "jax")
    mj.model.save_checkpoint(prefix, 3, jsym,
                             {k: mj.nd.array(v) for k, v in args.items()},
                             {k: mj.nd.array(v) for k, v in aux.items()})
    sym, arg_params, aux_params = mt.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == jsym.tojson() == tsym.tojson()
    _assert_same_params(arg_params, args)
    _assert_same_params(aux_params, aux)
    conv_args, conv_aux = mt.convert.load_params(prefix + "-0003.params",
                                                 device=mt.cpu())
    _assert_same_params(conv_args, args)
    _assert_same_params(conv_aux, aux)


def test_port_checkpoint_loads_in_jax(tmp_path):
    tsym, (args, aux) = _small_params()
    prefix = str(tmp_path / "port")
    arg_nd, aux_nd = mt.convert.params_from_numpy(args, aux, device=mt.cpu())
    mt.model.save_checkpoint(prefix, 0, tsym, arg_nd, aux_nd)
    sym, arg_params, aux_params = mj.model.load_checkpoint(prefix, 0)
    assert sym.tojson() == tsym.tojson()
    _assert_same_params(arg_params, args)
    _assert_same_params(aux_params, aux)
    back_args, back_aux = mt.convert.params_to_numpy(arg_nd, aux_nd)
    for k in args:
        np.testing.assert_array_equal(back_args[k], args[k])
    for k in aux:
        np.testing.assert_array_equal(back_aux[k], aux[k])


def test_ndarray_save_load_list_and_dict(tmp_path):
    a = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                    ctx=mt.cpu())
    b = mt.nd.zeros((4,), ctx=mt.cpu())
    f = str(tmp_path / "x.params")
    mt.nd.save(f, [a, b])
    got = mj.nd.load(f)
    assert isinstance(got, list) and len(got) == 2
    np.testing.assert_array_equal(got[0].asnumpy(), a.asnumpy())
    mj.nd.save(f, {"w": mj.nd.array(np.ones((2, 2), np.float32))})
    back = mt.nd.load(f, ctx=mt.cpu())
    assert list(back) == ["w"] and back["w"].shape == (2, 2)
