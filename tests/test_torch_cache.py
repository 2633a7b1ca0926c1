"""The KV-cache writes of the PyTorch port (K9 ``_cache_write_row``, K10
``_cache_write_rows``, ``mxnet_tpu_torch/ops/cache.py``) against the JAX
package's.

On the CPU the port's wrappers run their plain versions; these must equal,
bit for bit, the JAX package's Pallas kernels run in interpret mode
(``MXNET_CACHE_SCATTER_IMPL=interpret``, as its own tests pin them) and its
XLA fallbacks.  Caches are compared with ``torch.equal`` / byte equality,
never with a tolerance: the writes move data and compute nothing.  (A
one-hot blend would turn a ``-0.0`` cache cell into ``+0.0``; the scatter
keeps it, and so must the port.)
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops.registry import invoke_jax
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import build_graph_fn
from mxnet_tpu_torch.ops import cache as kv
from mxnet_tpu_torch.ops.registry import invoke

torch.set_num_threads(1)

DTYPES = [np.float32, np.float16]


def _jax(op, mode, monkeypatch, *arrays):
    monkeypatch.setenv("MXNET_CACHE_SCATTER_IMPL", mode)
    return np.asarray(invoke_jax(op, {}, *[jnp.asarray(a)
                                           for a in arrays])[0])


def _row_inputs(dtype, positions, T=16, d=8):
    n = len(positions)
    rng = np.random.default_rng(7 + n + T)
    cache = rng.standard_normal((n, T, d)).astype(dtype)
    cache[0, 0, 0] = -0.0                  # signed zero survives a write
    row = rng.standard_normal((n, d)).astype(dtype)
    return cache, row, np.asarray(positions, np.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f16"])
@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("positions", [
    [0, 0, 0, 0],                # edge: position 0
    [15, 15, 15, 15],            # edge: T - 1
    [3, 0, 15, 7],               # mixed
    [-3, 20, 2.7, 15.9],         # clamped out of range, truncated
], ids=["pos0", "posmax", "mixed", "clamp"])
def test_write_row_plain_matches_jax_bitwise(dtype, mode, positions,
                                             monkeypatch):
    cache, row, pos = _row_inputs(dtype, positions)
    want = _jax("_cache_write_row", mode, monkeypatch, cache, row, pos)
    got = kv.cache_write_row_plain(torch.from_numpy(cache.copy()),
                                   torch.from_numpy(row),
                                   torch.from_numpy(pos)).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def _rows_inputs(dtype, pos, count, T=16, K=3, d=8):
    n = len(pos)
    rng = np.random.default_rng(11 + n)
    cache = rng.standard_normal((n, T, d)).astype(dtype)
    cache[1, 0, 0] = -0.0
    rows = rng.standard_normal((n, K, d)).astype(dtype)
    return (cache, rows, np.asarray(pos, np.float32),
            np.asarray(count, np.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f16"])
@pytest.mark.parametrize("mode", ["interpret", "xla"])
@pytest.mark.parametrize("pos,count", [
    ([0, 5, 13, 15], [0, 3, 1, 3]),        # count 0 and K; 15+j overshoots
    ([14, 0, 15, 13], [3, 3, 2, 3]),       # windows straddling the end
    ([-1, 2, 7, 12], [3, 2, 5, -1]),       # pos < 0; count clamped to [0, K]
], ids=["counts", "straddle", "clamps"])
def test_write_rows_plain_matches_jax_bitwise(dtype, mode, pos, count,
                                              monkeypatch):
    cache, rows, pos, cnt = _rows_inputs(dtype, pos, count)
    want = _jax("_cache_write_rows", mode, monkeypatch, cache, rows, pos, cnt)
    got = kv.cache_write_rows_plain(torch.from_numpy(cache.copy()),
                                    torch.from_numpy(rows),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(cnt)).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_writes_touch_only_their_rows_and_work_in_place():
    cache, row, pos = _row_inputs(np.float32, [0, 15, 4, 9])
    c = torch.from_numpy(cache.copy())
    out = kv.cache_write_row(c, torch.from_numpy(row), torch.from_numpy(pos))
    assert out is c                       # the input's storage, returned
    written = np.zeros(cache.shape[:2], bool)
    written[np.arange(4), pos.astype(int)] = True
    assert np.array_equal(c.numpy()[~written], cache[~written])
    assert np.array_equal(c.numpy()[written], row)

    cache, rows, pos, cnt = _rows_inputs(np.float32, [2, 14, 0, 6],
                                         [2, 3, 0, 1])
    c = torch.from_numpy(cache.copy())
    assert kv.cache_write_rows(c, torch.from_numpy(rows),
                               torch.from_numpy(pos),
                               torch.from_numpy(cnt)) is c
    written = np.zeros(cache.shape[:2], bool)
    for i in range(4):
        for j in range(int(cnt[i])):
            if int(pos[i]) + j < cache.shape[1]:
                written[i, int(pos[i]) + j] = True
                assert np.array_equal(c.numpy()[i, int(pos[i]) + j],
                                      rows[i, j])
    assert written.sum() == 5             # 2 + 2 (one past the end) + 0 + 1
    assert np.array_equal(c.numpy()[~written], cache[~written])


def test_ops_match_invoke_jax_and_cast_rows(monkeypatch):
    """The registered ops (rows given in float32 to a float16 cache are
    cast, as ``jnp.asarray(row, cache.dtype)``)."""
    monkeypatch.setenv("MXNET_CACHE_SCATTER_IMPL", "interpret")
    cache, row, pos = _row_inputs(np.float16, [1, 15, 0, 3])
    row = row.astype(np.float32) * 3.3
    want = np.asarray(invoke_jax("_cache_write_row", {"clip": False},
                                 jnp.asarray(cache), jnp.asarray(row),
                                 jnp.asarray(pos))[0])
    got = invoke("_cache_write_row", {"clip": False},
                 torch.from_numpy(cache.copy()), torch.from_numpy(row),
                 torch.from_numpy(pos))[0].numpy()
    assert got.tobytes() == want.tobytes()
    cache, rows, pos, cnt = _rows_inputs(np.float16, [0, 5, 13, 15],
                                         [1, 3, 2, 3])
    args = (cache, rows.astype(np.float32), pos, cnt)
    want = np.asarray(invoke_jax("_cache_write_rows", {},
                                 *[jnp.asarray(a) for a in args])[0])
    got = invoke("_cache_write_rows", {},
                 *[torch.from_numpy(a.copy()) for a in args])[0].numpy()
    assert got.tobytes() == want.tobytes()


def test_training_mode_is_functional_and_differentiable():
    cache, row, pos = _row_inputs(np.float32, [2, 3, 0, 15])
    c = torch.from_numpy(cache.copy()).requires_grad_(True)
    r = torch.from_numpy(row).requires_grad_(True)
    out = invoke("_cache_write_row", {}, c, r, torch.from_numpy(pos),
                 training=True)[0]
    assert out is not c and np.array_equal(c.detach().numpy(), cache)
    out.sum().backward()
    assert torch.equal(r.grad, torch.ones_like(r))
    g = torch.ones_like(c)
    g[torch.arange(4), torch.from_numpy(pos).long()] = 0
    assert torch.equal(c.grad, g)


def test_meta_tensors_take_the_plain_version():
    before = [k.launches for k in kv.KERNEL_WRAPPERS]
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    assert kv.cache_write_row(m(8, 128, 200), m(8, 200), m(8)).shape == \
        (8, 128, 200)
    assert kv.cache_write_rows(m(8, 128, 200), m(8, 5, 200), m(8),
                               m(8)).shape == (8, 128, 200)
    assert [k.launches for k in kv.KERNEL_WRAPPERS] == before


def _write_graph(consumers):
    cache, row, pos = (mt.sym.Variable(n) for n in ("cache", "row", "pos"))
    out = mt.sym._cache_write_row(cache, row, pos, name="w")
    return mt.sym.Group([out] + ([cache * 1.0] if consumers > 1 else []))


@pytest.mark.parametrize("consumers", [1, 2])
@pytest.mark.parametrize("donate", [False, True])
def test_executor_writes_a_cache_in_place_only_when_it_owns_it(consumers,
                                                               donate):
    """A donated cache with no other reader is written in place; an
    undonated one, or one another node reads, is copied first and keeps
    its value."""
    sym = _write_graph(consumers)
    names = sym.list_arguments()
    cache, row, pos = _row_inputs(np.float32, [1, 2, 3, 4])
    vals = {"cache": torch.from_numpy(cache.copy()),
            "row": torch.from_numpy(row), "pos": torch.from_numpy(pos)}
    fn = build_graph_fn(sym, names, [])
    outs, _ = fn([vals[n] for n in names], [],
                 donated=("cache",) if donate else ())
    in_place = donate and consumers == 1
    assert (outs[0] is vals["cache"]) == in_place
    assert np.array_equal(vals["cache"].numpy(), cache) != in_place
    if consumers > 1:
        assert np.array_equal(outs[1].numpy(), cache)
    want = cache.copy()
    want[np.arange(4), pos.astype(int)] = row
    assert np.array_equal(outs[0].numpy(), want)
