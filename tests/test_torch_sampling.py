"""The port's samplers (``graphneuralnetwork_tpu_torch/sampling/``) against
the JAX package's on the CPU.

The host samplers are numpy in both packages: with the same inputs and a
``default_rng`` of the same seed they must give the same arrays bit for
bit and leave the generator in the same state (the next draw is equal).
The JAX samplers prefer a C++ engine with draws of its own; the port has
none, so they are compared with JAX's ``use_native=False``. The device
sampler draws from a ``torch.Generator`` (JAX's threefry keys cannot be
reproduced), so only its semantics are checked, on a CPU generator: every
draw a true neighbour, an isolated node repeating itself, the hop shapes,
and no offset at or past a node's degree; its table is equal to JAX's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.sampling import alias as j_alias  # noqa: E402
from graphneuralnetwork_tpu.sampling import neighbor as j_neighbor  # noqa: E402
from graphneuralnetwork_tpu.sampling import skipgram as j_skipgram  # noqa: E402
from graphneuralnetwork_tpu.sampling import walks as j_walks  # noqa: E402
from graphneuralnetwork_tpu.sampling.device_neighbor import (  # noqa: E402
    build_device_neighbor_table as j_build_table)
from graphneuralnetwork_tpu_torch.sampling import alias as t_alias  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import device_neighbor as t_dev  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import neighbor as t_neighbor  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import skipgram as t_skipgram  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import walks as t_walks  # noqa: E402

N, E = 60, 300


@pytest.fixture(scope="module")
def graph():
    """A random directed graph in which nodes 20-24 send no edge (zero
    out-degree), with duplicate edges."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, N - 5, E)
    s = np.where(s >= 20, s + 5, s).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    w = rng.random(E).astype(np.float32)
    return s, r, w


def _same_state(a: np.random.Generator, b: np.random.Generator) -> None:
    assert a.random() == b.random()


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_from_edges_equals_jax(graph, weighted):
    s, r, w = graph
    args = (s, r, N) + ((w,) if weighted else ())
    for got, want in zip(t_walks.csr_from_edges(*args),
                         j_walks.csr_from_edges(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fanout", [1, 4, 10])
def test_sample_neighbors_equals_jax_numpy_path(graph, fanout):
    s, r, _ = graph
    indptr, indices, _ = t_walks.csr_from_edges(s, r, N)
    nodes = np.array([0, 3, 22, 21, 7, 3, 55], np.int64)  # 20-24: deg 0
    ja, ta = np.random.default_rng(11), np.random.default_rng(11)
    want = j_neighbor.sample_neighbors(nodes, fanout, indptr, indices, ja,
                                       use_native=False)
    got = t_neighbor.sample_neighbors(nodes, fanout, indptr, indices, ta)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    _same_state(ja, ta)
    # an isolated node repeats itself
    assert (got.reshape(len(nodes), fanout)[2] == 22).all()


def test_multihop_sampling_equals_jax_numpy_path(graph, monkeypatch):
    s, r, _ = graph
    indptr, indices, _ = t_walks.csr_from_edges(s, r, N)
    monkeypatch.setattr(j_neighbor, "sample_neighbors", functools.partial(
        j_neighbor.sample_neighbors, use_native=False))
    nodes = np.arange(0, N, 3)
    ja, ta = np.random.default_rng(5), np.random.default_rng(5)
    want = j_neighbor.multihop_sampling(nodes, (3, 2), indptr, indices, ja)
    got = t_neighbor.multihop_sampling(nodes, (3, 2), indptr, indices, ta)
    assert [len(h) for h in got] == [20, 60, 120]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    _same_state(ja, ta)


def test_isolated_last_node_repeats_itself():
    """Node 3 has no neighbours and its CSR row starts at the end of
    ``indices``: JAX's numpy path reads past the end there and raises; the
    port's samplers repeat the node, as for any node without neighbours."""
    indptr, indices, _ = t_walks.csr_from_edges([0, 1, 2], [1, 2, 0], 4)
    assert indptr[3] == len(indices)
    nodes = np.array([3, 0, 3])
    with pytest.raises(IndexError):
        j_neighbor.sample_neighbors(nodes, 2, indptr, indices,
                                    np.random.default_rng(0),
                                    use_native=False)
    got = t_neighbor.sample_neighbors(nodes, 2, indptr, indices,
                                      np.random.default_rng(0))
    np.testing.assert_array_equal(got, [3, 3, 1, 1, 3, 3])
    walks = t_walks.uniform_walks(indptr, indices, nodes, 3,
                                  np.random.default_rng(0))
    np.testing.assert_array_equal(walks, [[3, 3, 3], [0, 1, 2], [3, 3, 3]])
    empty = np.zeros(0, np.int32)
    np.testing.assert_array_equal(
        t_neighbor.sample_neighbors([0, 1], 2, np.zeros(3, np.int64), empty,
                                    np.random.default_rng(0)),
        [0, 0, 1, 1])


@pytest.mark.parametrize("length", [1, 2, 6])
def test_uniform_walks_equal_jax_numpy_path(graph, length):
    s, r, _ = graph
    indptr, indices, _ = t_walks.csr_from_edges(s, r, N)
    starts = np.array([0, 1, 2, 23, 10, 10, 57])
    ja, ta = np.random.default_rng(2), np.random.default_rng(2)
    want = j_walks.uniform_walks(indptr, indices, starts, length, ja,
                                 use_native=False)
    got = t_walks.uniform_walks(indptr, indices, starts, length, ta)
    assert got.shape == (len(starts), length) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    _same_state(ja, ta)


@pytest.mark.parametrize("probs", [
    np.array([1.0, 2.0, 3.0, 4.0]),
    np.random.default_rng(3).random(37) ** 3,
    np.array([5.0]),
    np.zeros(0),
])
def test_alias_table_and_draws_equal_jax(probs):
    got, want = t_alias.build_alias_table(probs), \
        j_alias.build_alias_table(probs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if len(probs):
        ja, ta = np.random.default_rng(9), np.random.default_rng(9)
        np.testing.assert_array_equal(
            t_alias.sample_alias(*got, ta, (40,)),
            j_alias.sample_alias(*want, ja, (40,)))
        _same_state(ja, ta)


def test_alias_draws_follow_the_weights():
    probs = np.array([1.0, 2.0, 3.0, 4.0])
    acc, al = t_alias.build_alias_table(probs)
    draws = t_alias.sample_alias(acc, al, np.random.default_rng(0), 200_000)
    freq = np.bincount(draws, minlength=4) / 200_000
    np.testing.assert_allclose(freq, probs / probs.sum(), atol=5e-3)


@pytest.mark.parametrize("exclude", [False, True])
def test_negative_sampler_equals_jax(graph, exclude):
    s, r, _ = graph
    indptr, _, _ = t_walks.csr_from_edges(s, r, N)
    deg = np.maximum((indptr[1:] - indptr[:-1]).astype(np.float64), 1)
    jn, tn = j_skipgram.NegativeSampler(deg), t_skipgram.NegativeSampler(deg)
    np.testing.assert_array_equal(tn.accept, jn.accept)
    np.testing.assert_array_equal(tn.alias, jn.alias)
    shape = (32, 5)
    excl = (np.random.default_rng(4).integers(0, N, (32, 1))
            if exclude else None)
    ja, ta = np.random.default_rng(8), np.random.default_rng(8)
    np.testing.assert_array_equal(tn.draw(shape, ta, exclude=excl),
                                  jn.draw(shape, ja, exclude=excl))
    _same_state(ja, ta)


@pytest.mark.parametrize("max_deg", [None, 3, 1])
def test_device_neighbor_table_equals_jax(graph, max_deg):
    s, r, _ = graph
    indptr, indices, _ = t_walks.csr_from_edges(s, r, N)
    jt, jd = j_build_table(indptr, indices, max_deg=max_deg)
    tt, td = t_dev.build_device_neighbor_table(indptr, indices,
                                               max_deg=max_deg, device="cpu")
    assert tt.dtype == td.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if max_deg is not None:   # some rows are capped (subsampled)
        assert ((indptr[1:] - indptr[:-1]) > max_deg).any()


def test_device_neighbor_table_needs_a_device():
    """Like every entry point, the table goes to the card unless the
    caller asks for the CPU."""
    indptr, indices = np.array([0, 1, 1]), np.array([1], np.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_dev.build_device_neighbor_table(indptr, indices)


@pytest.fixture(scope="module")
def table(graph):
    s, r, _ = graph
    indptr, indices, _ = t_walks.csr_from_edges(s, r, N)
    tab, deg = t_dev.build_device_neighbor_table(indptr, indices,
                                                 device="cpu")
    return indptr, indices, tab, deg


def test_device_sampler_draws_true_neighbours(table):
    indptr, indices, tab, deg = table
    nodes = torch.tensor([0, 5, 24, 12], dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    out = t_dev.device_sample_neighbors(gen, nodes, tab, deg, 64)
    assert out.dtype == torch.int32 and out.shape == (4 * 64,)
    out = out.reshape(4, 64).numpy()
    for k, v in enumerate(nodes.tolist()):
        nbrs = set(indices[indptr[v]:indptr[v + 1]].tolist())
        if nbrs:
            assert set(out[k].tolist()) <= nbrs
            # uniform with replacement: 64 draws reach most neighbours
            assert len(set(out[k].tolist())) >= min(len(nbrs), 2)
        else:   # an isolated node repeats itself
            assert (out[k] == v).all()


def test_device_multihop_shapes_and_edges(table):
    indptr, indices, tab, deg = table
    nodes = torch.tensor([0, 5, 24], dtype=torch.int32)
    hops = t_dev.device_multihop_sampling(torch.Generator().manual_seed(2),
                                          nodes, (4, 3), tab, deg)
    assert [h.shape[0] for h in hops] == [3, 12, 36]
    assert all(h.dtype == torch.int32 for h in hops)
    for prev, nxt, f in ((hops[0], hops[1], 4), (hops[1], hops[2], 3)):
        for u, vs in zip(prev.tolist(), nxt.reshape(-1, f).tolist()):
            nbrs = set(indices[indptr[u]:indptr[u + 1]].tolist()) or {u}
            assert set(vs) <= nbrs


def test_device_uniform_walks(table):
    indptr, indices, tab, deg = table
    starts = torch.tensor([0, 3, 20, 59], dtype=torch.int32)
    walks = t_dev.device_uniform_walks(torch.Generator().manual_seed(3),
                                       starts, 5, tab, deg)
    assert walks.shape == (4, 5) and walks.dtype == torch.int32
    assert torch.equal(walks[:, 0], starts)
    for row in walks.tolist():
        for u, v in zip(row[:-1], row[1:]):
            nbrs = set(indices[indptr[u]:indptr[u + 1]].tolist()) or {u}
            assert v in nbrs
    one = t_dev.device_uniform_walks(torch.Generator().manual_seed(3),
                                     starts, 1, tab, deg)
    assert torch.equal(one[:, 0], starts) and one.shape == (4, 1)


def test_draw_offsets_never_reach_the_degree():
    """floor(u·d) of a float32 u near 1 and a large d can round up to d;
    the offset is clamped to d - 1. Zero degree draws offset 0."""
    u = torch.tensor([[0.0], [0.5], [1.0 - 2.0 ** -24], [1.0], [0.999],
                      [0.3]])
    d = torch.tensor([[7], [7], [2 ** 24 + 3], [5], [1], [0]],
                     dtype=torch.int32)
    off = t_dev.draw_offsets(u, d)
    assert off.tolist() == [[0], [3], [2 ** 24 + 2], [4], [0], [0]]
    big = torch.full((1, 4096), 123_456_789, dtype=torch.int32)
    top = t_dev.draw_offsets(torch.full((1, 4096), 1.0 - 2.0 ** -24), big)
    assert int(top.max()) <= 123_456_788


def test_device_sampler_is_uniform(table):
    """Each neighbour entry of the node of highest degree is drawn about
    equally often (a duplicate edge counts twice)."""
    indptr, indices, tab, deg = table
    v = int(np.argmax(indptr[1:] - indptr[:-1]))
    row = indices[indptr[v]:indptr[v + 1]]
    draws = 4000 * len(row)
    out = t_dev.device_sample_neighbors(
        torch.Generator().manual_seed(4), torch.tensor([v]), tab, deg,
        draws).numpy()
    for x in set(row.tolist()):
        want = (row == x).sum() / len(row)
        assert abs((out == x).mean() - want) < 0.01, x
