"""The hybrid layout of the PyTorch port against the JAX package's: every
array of ``build_bcsr``/``build_hybrid`` (tiles, ids, spans, the COO
remainders, the fine spans and the dropout alignment maps) is equal, for
symmetric and directed graphs and float32 and bfloat16 tiles; the loaders
relabel the same nodes and split indices."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.data import load_cora as j_load_cora  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import (  # noqa: E402
    load_cora as t_load_cora)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def community_edges(seed=0, n=512, e=8192, comm=64, symmetric=False):
    """The JAX attend tests' fixture graph: ~90 % of the edges inside
    blocks of ``comm`` nodes."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    base = (s // comm) * comm
    r = np.where(intra, np.minimum(base + rng.integers(0, comm, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    s, r = s[keep].astype(np.int32), r[keep].astype(np.int32)
    if symmetric:
        s, r = jgraph.symmetrize(s, r)
    return s, r, n


def _equal(t_arr, j_arr, what):
    t_np = t_arr.float().numpy() if t_arr.dtype == torch.bfloat16 \
        else t_arr.numpy()
    j_np = np.asarray(j_arr)
    if j_np.dtype == jnp.bfloat16:
        j_np = j_np.astype(np.float32)
    assert t_np.shape == j_np.shape, what
    np.testing.assert_array_equal(t_np, j_np, err_msg=what)


def assert_bcsr_equal(t, j, what):
    for name in ("tiles", "col_ids", "row_ids", "tile_off", "tile_cnt"):
        _equal(getattr(t, name), getattr(j, name), f"{what}.{name}")
    for name in ("n_nodes", "n_edges", "n_node_pad", "max_tiles"):
        assert getattr(t, name) == getattr(j, name), f"{what}.{name}"


def assert_graph_equal(t, j, what):
    for name in ("senders", "receivers", "edge_weight", "chunk_off",
                 "chunk_cnt"):
        _equal(getattr(t, name), getattr(j, name), f"{what}.{name}")
    for name in ("n_nodes", "n_edges", "n_node_pad", "max_chunks"):
        assert getattr(t, name) == getattr(j, name), f"{what}.{name}"
    # the port's CSR offsets span exactly the real, receiver-sorted edges
    recv = np.asarray(j.receivers)[:j.n_edges]
    np.testing.assert_array_equal(
        t.row_ptr.numpy(), jgraph.csr_offsets(recv, j.n_nodes))


def assert_hybrid_equal(t, j):
    assert_bcsr_equal(t.bcsr, j.bcsr, "bcsr")
    assert_bcsr_equal(t.bcsr_t, j.bcsr_t, "bcsr_t")
    assert (t.bcsr_t is t.bcsr) == (j.bcsr_t is j.bcsr)
    assert_graph_equal(t.rem, j.rem, "rem")
    assert_graph_equal(t.rem_t, j.rem_t, "rem_t")
    for name in ("rem_fine_off", "rem_fine_cnt", "rem_t_fine_off",
                 "rem_t_fine_cnt", "bits_tmap", "rem_t_eperm"):
        _equal(getattr(t, name), getattr(j, name), name)
    assert t.rem_fine_max == j.rem_fine_max
    assert t.rem_t_fine_max == j.rem_t_fine_max
    assert t.n_edges == j.n_edges and t.tiled_fraction == j.tiled_fraction


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("symmetric", [False, True])
def test_build_hybrid_arrays_equal_jax(symmetric, dtype):
    s, r, n = community_edges(symmetric=symmetric)
    jd, td = DTYPES[dtype]
    # symmetrising doubles the edges: a higher threshold keeps a remainder
    fill = 192 if symmetric else 48
    j = jbcsr.build_hybrid(s, r, n, min_edges_per_tile=fill,
                           symmetric=symmetric, dtype=jd)
    t = tbcsr.build_hybrid(s, r, n, min_edges_per_tile=fill,
                           symmetric=symmetric, dtype=td, device="cpu")
    assert t.bcsr.tiles.dtype == td and t.bcsr.n_tiles > 1
    assert t.rem.n_edges > 0 and t.symmetric == symmetric
    assert_hybrid_equal(t, j)


def test_build_hybrid_weighted_duplicates_and_no_tiles():
    """Weights and duplicate edges accumulate in the tiles; a graph whose
    tiles all stay below the fill threshold keeps one zero tile."""
    s, r, n = community_edges(seed=3, n=300, e=4000)
    s = np.concatenate([s, s[:50]])
    r = np.concatenate([r, r[:50]])
    w = np.random.default_rng(4).random(len(s)).astype(np.float32)
    assert_hybrid_equal(
        tbcsr.build_hybrid(s, r, n, w, min_edges_per_tile=40, device="cpu"),
        jbcsr.build_hybrid(s, r, n, w, min_edges_per_tile=40))
    sparse = tbcsr.build_hybrid(s[:200], r[:200], n, device="cpu")
    assert_hybrid_equal(sparse, jbcsr.build_hybrid(s[:200], r[:200], n))
    assert sparse.bcsr.n_tiles == 1 and sparse.bcsr.n_edges == 0


def test_build_bcsr_and_transpose_equal_jax():
    s, r, n = community_edges(seed=1)
    w = np.random.default_rng(2).random(len(s)).astype(np.float32)
    assert_bcsr_equal(tbcsr.build_bcsr(s, r, n, w, device="cpu"),
                      jbcsr.build_bcsr(s, r, n, w), "bcsr")
    assert_bcsr_equal(tbcsr.build_bcsr_transpose(s, r, n, w, device="cpu"),
                      jbcsr.build_bcsr_transpose(s, r, n, w), "bcsr_t")


def test_store_guard_raises_like_jax():
    s, r, n = community_edges(seed=2)
    for build in (jbcsr.build_bcsr,
                  lambda *a, **k: tbcsr.build_bcsr(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="lacks block locality"):
            build(s, r, n, max_bytes=1 << 16)


def test_hybrid_to_keeps_one_tile_store():
    s, r, n = community_edges(symmetric=True)
    hg = tbcsr.build_hybrid(s, r, n, symmetric=True, device="cpu")
    moved = hg.to("cpu")
    assert moved.symmetric and moved.bcsr_t is moved.bcsr


@pytest.fixture(scope="module")
def cora_hybrid():
    return (j_load_cora(seed=0, layout="hybrid"),
            t_load_cora(seed=0, layout="hybrid", device="cpu"))


def _assert_same_split(t, j):
    np.testing.assert_array_equal(t.features.numpy(), np.asarray(j.features))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    for name in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    np.testing.assert_array_equal(t.raw_senders, j.raw_senders)
    np.testing.assert_array_equal(t.raw_receivers, j.raw_receivers)


def test_load_cora_hybrid_equals_jax(cora_hybrid):
    """The same clustering permutation: relabelled graph, permuted features
    and labels, split indices through the inverse permutation."""
    j, t = cora_hybrid
    assert t.num_classes == j.num_classes
    _assert_same_split(t, j)
    assert_hybrid_equal(t.graph, j.graph)
    # a relabelling, not a new split: the same labels at the split nodes
    plain = t_load_cora(seed=0, layout="coo", device="cpu")
    for name in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(
            t.labels[getattr(t, name)].numpy(),
            plain.labels[getattr(plain, name)].numpy())


def test_gat_auto_layout_and_rebuild_equal_jax(cora_hybrid):
    """GAT under ``auto`` goes hybrid on Cora, reuses the probe's
    permutation, and the loader's unit-weight GAT hybrid equals the JAX
    CLI's rebuild (``cli.py:132-150``), in float32 and bfloat16 tiles."""
    j_hyb, _ = cora_hybrid
    j = j_load_cora(seed=0, layout="auto", layout_objective="attention")
    s2, r2 = jgraph.add_self_loops(
        *jgraph.symmetrize(j.raw_senders, j.raw_receivers),
        int(j.features.shape[0]))
    for jd, td in DTYPES.values():
        t = t_load_cora(seed=0, layout="auto", layout_objective="attention",
                        device="cpu", model="gat", tile_dtype=td)
        assert hasattr(t.graph, "bcsr") and hasattr(j.graph, "bcsr")
        _assert_same_split(t, j)
        _assert_same_split(t, j_hyb)   # the probe's perm is the hybrid's
        assert_hybrid_equal(t.graph, jbcsr.build_hybrid(
            s2, r2, int(t.features.shape[0]), symmetric=True, dtype=jd))


def test_gat_explicit_hybrid_equals_auto(cora_hybrid):
    """``--layout hybrid`` clusters without a probe and builds the same GAT
    graph and relabelling as ``auto``."""
    j_hyb, _ = cora_hybrid
    explicit = t_load_cora(seed=0, layout="hybrid", device="cpu",
                           model="gat")
    auto = t_load_cora(seed=0, layout="auto", layout_objective="attention",
                       device="cpu", model="gat")
    _assert_same_split(explicit, j_hyb)
    s2, r2 = jgraph.add_self_loops(
        *jgraph.symmetrize(j_hyb.raw_senders, j_hyb.raw_receivers),
        int(explicit.features.shape[0]))
    for t in (explicit, auto):
        assert_hybrid_equal(t.graph, jbcsr.build_hybrid(
            s2, r2, int(t.features.shape[0]), symmetric=True))
    with pytest.raises(ValueError, match="unknown model"):
        t_load_cora(seed=0, device="cpu", model="sage")


def test_gcn_graph_hybrid_equals_jax():
    s, r, n = community_edges(seed=5, n=400, e=3000)
    jh, jperm = jgraph.gcn_graph_hybrid(s, r, n)
    th, tperm = tgraph.gcn_graph_hybrid(s, r, n, device="cpu")
    np.testing.assert_array_equal(tperm, jperm)
    assert_hybrid_equal(th, jh)
