"""The PyTorch port stands alone: no module of ``mxnet_tpu_torch`` and
neither ``chip_smoke.py``, ``chip_mma_probe.py`` nor ``chip_compare.py``
imports JAX, the JAX package or ``ml_dtypes`` (which the card's machine does not have; the
port reads bf16 numpy arrays by their dtype's name), and its entry points run on the card unless the caller asks for
the CPU."""
import ast
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _port_sources():
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "chip_mma_probe.py")
    yield os.path.join(ROOT, "chip_compare.py")


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 20
    bad = [(os.path.relpath(p, ROOT), root) for p in sources
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _relu_graph():
    return mt.sym.Activation(mt.sym.Variable("data"), act_type="relu")


def test_entry_points_without_ctx_raise_without_a_card(no_card, tmp_path):
    sym = _relu_graph()
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.Predictor(sym, {}, {}, {"data": (1, 3)})
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.ServingEngine(sym, {}, {}, {"data": (3,)})
    prefix = str(tmp_path / "relu")
    mt.model.save_checkpoint(prefix, 0, sym, {}, {})
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.ServingEngine.from_checkpoint(prefix, 0, {"data": (3,)})
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.load_checkpoint_predictor(prefix, 0, {"data": (1, 3)})
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.mod.Module(sym, label_names=None)


def test_entry_points_with_cpu_ctx_run_without_a_card(no_card):
    sym = _relu_graph()
    out = mt.Predictor(sym, {}, {}, {"data": (1, 3)}, ctx=mt.cpu()).forward(
        data=np.array([[-1.0, 0.0, 2.0]], np.float32)).get_output(0)
    np.testing.assert_array_equal(out, [[0.0, 0.0, 2.0]])
    with mt.ServingEngine(sym, {}, {}, {"data": (3,)}, ctx=mt.cpu()) as eng:
        np.testing.assert_array_equal(
            eng.predict(np.array([-3.0, 1.0, 0.5]), timeout=30),
            [0.0, 1.0, 0.5])
    mod = mt.mod.Module(sym, label_names=None, context=mt.cpu())
    mod.bind([("data", (1, 3))], for_training=False)
    mod.init_params()
    mod.forward(mt.io.DataBatch([mt.nd.array([[-1.0, 0.0, 2.0]],
                                             ctx=mt.cpu())]))
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                  [[0.0, 0.0, 2.0]])


def test_rnn_entry_points_want_a_card_unless_given_cpu(no_card):
    """BucketingModule binds its Modules on the card, and Gluon's RNN
    layer initializes there, unless told the CPU."""
    def sym_gen(seq_len):
        return mt.sym.Activation(mt.sym.Variable("data"),
                                 act_type="relu"), ("data",), None
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=3)
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mod.bind([("data", (1, 3))], for_training=False)
    layer = mt.gluon.rnn.LSTM(4, input_size=3)
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        layer.initialize()
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=3,
                                 context=mt.cpu())
    mod.bind([("data", (1, 3))], for_training=False)
    mod.init_params()
    mod.forward(mt.io.DataBatch([mt.nd.array([[-1.0, 0.0, 2.0]],
                                             ctx=mt.cpu())], bucket_key=3))
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(),
                                  [[0.0, 0.0, 2.0]])


def test_contexts_name_torch_devices():
    assert mt.cpu().device == torch.device("cpu")
    assert mt.gpu(1).device == torch.device("cuda", 1)
    assert mt.Context.of(torch.device("cuda", 1)) == mt.gpu(1)
    assert not hasattr(mt, "tpu")


def _decode_step():
    """The smallest decode step: logits = FC(Embedding(token)), no state."""
    emb = mt.sym.Embedding(mt.sym.Variable("token"), input_dim=4,
                           output_dim=4, name="emb")
    logits = mt.sym.FullyConnected(emb, num_hidden=4, name="fc")
    eye = mt.nd.array(np.eye(4, dtype=np.float32), ctx=mt.cpu())
    params = {"emb_weight": eye, "fc_weight": eye,
              "fc_bias": mt.nd.array(np.zeros(4, np.float32), ctx=mt.cpu())}
    return mt.sym.Group([logits]), params


def test_decode_engine_wants_a_card_unless_given_cpu(no_card):
    step, params = _decode_step()
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.DecodeEngine(step, params, {}, [], num_slots=2, max_len=8)
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.serving.StepProgram(step, params, {}, [], 2)
    with mt.DecodeEngine(step, params, {}, [], num_slots=2, max_len=8,
                         ctx=mt.cpu()) as eng:
        res = eng.generate([2], max_new_tokens=3, timeout=30)
    assert list(res.tokens) == [2, 2, 2]    # the identity model repeats


def test_imperative_entry_points_want_a_card_unless_given_cpu(no_card,
                                                             tmp_path):
    """nd.array, nd.zeros, nd.load, an op without array inputs and
    CudaModule raise without a card and a ctx; ctx=cpu() or a
    ``with mt.cpu():`` scope runs them on the CPU."""
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.nd.array([1.0, 2.0])
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.nd.zeros((2,))
    f = str(tmp_path / "w.params")
    mt.nd.save(f, {"w": mt.nd.zeros((2,), ctx=mt.cpu())})
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.nd.load(f)
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.nd._arange(start=0, stop=3)
    with pytest.raises(mt.MXNetError, match="CUDA card"):
        mt.rtc.CudaModule('extern "C" __global__ void k() {}')
    assert mt.nd.zeros((2,), ctx=mt.cpu()).context == mt.cpu()
    with mt.cpu():
        r = mt.nd._arange(start=0, stop=3)
        y = mt.nd.Activation(mt.nd.array([-1.0, 2.0]), act_type="relu")
        w = mt.nd.load(f)["w"]
    assert r.context == y.context == w.context == mt.cpu()
    np.testing.assert_array_equal(y.asnumpy(), [0.0, 2.0])


def test_params_from_numpy_wants_a_card_unless_given_cpu(no_card):
    """Without ``device`` the arrays go to ``current_context()``: an error
    without a card, the CPU inside ``with mt.cpu():`` or with
    device=mt.cpu()."""
    args = {"w": np.ones((2, 3), np.float32)}
    aux = {"m": np.zeros(3, np.float32)}
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.convert.params_from_numpy(args, aux)
    a, x = mt.convert.params_from_numpy(args, aux, device=mt.cpu())
    assert a["w"].context == x["m"].context == mt.cpu()
    with mt.cpu():
        a, x = mt.convert.params_from_numpy(args, aux)
    assert a["w"].context == x["m"].context == mt.cpu()
    np.testing.assert_array_equal(a["w"].asnumpy(), args["w"])


def test_updater_set_states_loads_on_the_host_without_a_card(no_card):
    """Optimizer states written by get_states load onto the CPU with no
    card and no ``with mt.cpu():``, and move to the weight's context at
    its next update."""
    w = mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu())
    g = mt.nd.array(np.full((2, 3), 0.5, np.float32), ctx=mt.cpu())
    u = mt.optimizer.get_updater(mt.optimizer.SGD(momentum=0.9))
    u(0, g, w)
    v = mt.optimizer.get_updater(mt.optimizer.SGD(momentum=0.9))
    v.set_states(u.get_states())
    assert v.states[0].context == mt.cpu()
    v(0, g, w)
    assert v.states[0].context == w.context == mt.cpu()


@pytest.mark.cuda
def test_params_from_numpy_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, x = mt.convert.params_from_numpy({"w": np.ones((2, 3), np.float32)},
                                        {"m": np.zeros(3, np.float32)})
    assert a["w"].context == x["m"].context == mt.gpu(0)
    assert a["w"]._data.device == torch.device("cuda", 0)


_DATA_PATH_MODULES = ("mxnet_tpu_torch.recordio", "mxnet_tpu_torch.image",
                      "mxnet_tpu_torch.io", "mxnet_tpu_torch.lr_scheduler")
# what the data path must not pull in: JAX, the JAX package, and the image
# codecs, which it imports only to decode or resize
_NOT_ON_THE_DATA_PATH = ("jax", "jaxlib", "mxnet_tpu", "cv2", "PIL")


def test_data_path_imports_neither_jax_nor_the_image_codecs():
    """In a fresh interpreter, importing the port's data-path modules
    loads no JAX, no JAX package, no cv2 and no PIL."""
    import subprocess
    import sys
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(r for r in %r if r in sys.modules))"
            % (_DATA_PATH_MODULES, _NOT_ON_THE_DATA_PATH))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_spawned_pipeline_workers_load_neither_jax_nor_cuda(tmp_path):
    """A worker process of ImageRecordIter(use_processes=True) (spawned)
    has imported the port, and neither JAX, the JAX package, cv2 nor PIL
    for raw records, and has not initialized CUDA."""
    from mxnet_tpu_torch import recordio
    rec = str(tmp_path / "raw.rec")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "raw.idx"), rec, "w")
    for i in range(4):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     bytes(range(48))))
    w.close()
    it = mt.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 4, 4),
                               raw_shape=(4, 4, 3), batch_size=2,
                               preprocess_threads=1, use_processes=True)
    try:
        assert it.next().data[0].shape == (2, 3, 4, 4)
        probe = ("(sorted(r for r in %r if r in __import__('sys').modules), "
                 "'mxnet_tpu_torch.image.mp_iter' in "
                 "__import__('sys').modules, "
                 "__import__('torch').cuda.is_initialized())"
                 % (_NOT_ON_THE_DATA_PATH,))
        loaded, has_port, cuda = it._ppool._exe.submit(eval, probe).result(
            timeout=120)
    finally:
        it.close()
    assert loaded == [] and has_port and not cuda


def test_initializers_write_their_draws_without_a_host_round_trip(
        monkeypatch):
    """Uniform, Normal and Xavier draw on the array's own device and write
    the tensor in place, with no numpy copy (there is none of a CUDA
    tensor): assigning a tensor to an NDArray takes it as it is."""
    from mxnet_tpu_torch.ndarray import ndarray as nd_mod

    def no_host_copy(a):
        raise AssertionError("a tensor went through numpy")
    monkeypatch.setattr(nd_mod, "_host_tensor", no_host_copy)
    for init in (mt.init.Uniform(0.1), mt.init.Normal(0.1), mt.init.Xavier()):
        w = mt.nd.zeros((4, 6), ctx=mt.cpu())
        init(mt.init.InitDesc("fc_weight"), w)
        assert float(np.abs(w.asnumpy()).max()) > 0
    w = mt.nd.zeros((2, 3), ctx=mt.cpu())
    w[:] = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(w.asnumpy(), np.arange(6.0).reshape(2, 3))


@pytest.mark.cuda
def test_xavier_initializes_parameters_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = mt.nd.zeros((64, 32), ctx=mt.gpu(0))
    mt.init.Xavier()(mt.init.InitDesc("fc_weight"), w)
    assert w._data.device == torch.device("cuda", 0)
    bound = (3.0 / ((64 + 32) / 2.0)) ** 0.5
    assert 0 < float(w._data.abs().max()) <= bound
