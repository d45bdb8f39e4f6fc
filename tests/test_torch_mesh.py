"""The port's mesh (``parallel/mesh.py``) on the CPU: over eight CPU
entries it equals the JAX package's ``ShardedRefIndex`` on the eight
virtual CPU devices of conftest.py, and the native engine; the sharded
all-vs-all equals the port's ``all2all_jax``; padding lanes are dropped;
``make_mesh()`` without a card raises. Exact comparisons (integers)."""
import jax
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.parallel import mesh as jmesh
from lzani_tpu.params import Params
from lzani_tpu_torch.ops.engine_jax import all2all_jax
from lzani_tpu_torch.parallel import mesh as tmesh

CPU8 = ["cpu"] * 8


# the generator of tests/test_mesh.py
def _toy_set(n=5, L=300, seed=7):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, L).astype(np.uint8)
    out = []
    for i in range(n):
        s = base.copy()
        s[:: (i + 3)] = (s[:: (i + 3)] + 1) % 4
        out.append(s[: L - 13 * i])
    return out


def test_sharded_parse_equals_jax_mesh_and_oracle():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    p = Params()
    codes = _toy_set()
    want = jmesh.ShardedRefIndex(codes[0], p, jmesh.make_mesh(
        jax.devices()[:8])).parse_batch(codes[1:], p)
    idx = tmesh.ShardedRefIndex(codes[0], p, tmesh.make_mesh(CPU8))
    got = idx.parse_batch(codes[1:], p)
    assert np.array_equal(got, want)
    assert got.shape == (len(codes) - 1, 3)
    for row, q in enumerate(codes[1:]):
        assert tuple(got[row]) == ne.parse_pair(codes[0], q, p)[0]


def test_sharded_all2all_equals_all2all_jax():
    p = Params()
    codes = _toy_set(4)
    st, st_one = {}, {}
    got = tmesh.all2all_sharded(codes, p, mesh=["cpu", "cpu", "cpu"],
                                stats=st)
    assert np.array_equal(got, all2all_jax(codes, p, device="cpu",
                                           stats=st_one))
    assert st == st_one     # one loop, one set of counters
    assert np.array_equal(got, ne.all2all(codes, p))
    csr = (np.array([0, 2, 3, 3, 5]), np.array([1, 3, 0, 0, 2], np.int32))
    got = tmesh.all2all_sharded(codes, p, mesh=CPU8, filter_csr=csr,
                                batch_size=1)
    assert np.array_equal(got, ne.all2all(codes, p, filter_csr=csr))


def test_padding_lanes_are_masked():
    """Two queries over eight entries: six padding lanes, dropped."""
    p = Params()
    codes = _toy_set(3)
    idx = tmesh.ShardedRefIndex(codes[0], p, CPU8)
    stats = idx.parse_batch(codes[1:3], p)
    assert stats.shape == (2, 3)
    for row in range(2):
        assert tuple(stats[row]) == ne.parse_pair(codes[0], codes[1 + row],
                                                  p)[0]


def test_make_mesh(monkeypatch):
    assert tmesh.make_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        tmesh.make_mesh([])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.all2all_sharded(_toy_set(2), Params())
