"""The halo partition of the PyTorch port (``parallel/halo.py``,
``parallel/halo_attention.py``) against the JAX package's on the CPU.

The host partitioners build byte-equal arrays for D = 2 and 4. A gloo world
of D spawned processes (``torch_world.py``, which imports only the port)
runs ``spmm_halo`` (plain and tiled), ``segment_max_halo`` (plain, tiled,
with in-degree-0 nodes), ``gat_halo``, ``gat_halo_attend`` on a tiled
partition, ``GATConv`` (with attention dropout), ``SAGEConv`` (sum, mean,
max) and HAN on halo graphs; JAX runs the same functions on the first D
devices of conftest's virtual mesh, on the same numpy inputs and weights
(``params.from_flax``). The ranks' rows, concatenated, and their summed
parameter gradients agree with JAX's within ``F32_TOL`` (both sum in
float32 in other orders), and with the port's own single-device results.
Each world is spawned once for the module; every case asserts in its own
test. The cases mirror ``tests/test_halo.py`` and the halo cases of
``tests/test_parallel.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.sharding import Mesh as JMesh  # noqa: E402

from graphneuralnetwork_tpu.core.graph import build_graph as j_build  # noqa: E402
from graphneuralnetwork_tpu.core.reorder import invert_permutation  # noqa: E402
from graphneuralnetwork_tpu.nn import HAN as JHAN  # noqa: E402
from graphneuralnetwork_tpu.nn.conv import (  # noqa: E402
    GATConv as JGATConv, SAGEConv as JSAGEConv)
from graphneuralnetwork_tpu.parallel import (  # noqa: E402
    boundary_edge_fraction as j_bfrac, gat_halo as j_gat_halo,
    partition_graph_halo as j_part,
    partition_graph_halo_clustered as j_part_clustered,
    segment_max_halo as j_segmax_halo, shard_nodes_halo as j_shard,
    spmm_halo as j_spmm_halo)
from graphneuralnetwork_tpu.parallel.halo_attention import (  # noqa: E402
    gat_halo_attend as j_attend)
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch.core.graph import build_graph  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.aggregate import (  # noqa: E402
    aggregate_gathered, gather_senders)
from graphneuralnetwork_tpu_torch.ops.segment import segment_max  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.spmm import spmm  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel import (  # noqa: E402
    Mesh, boundary_edge_fraction, partition_graph_halo,
    partition_graph_halo_clustered)
from graphneuralnetwork_tpu_torch.parallel.halo import (  # noqa: E402
    halo_slab, segment_max_local, spmm_halo_local)
from graphneuralnetwork_tpu_torch.parallel.halo_attention import (  # noqa: E402
    attend_local)
from graphneuralnetwork_tpu_torch.parallel.sharded import pad_rows  # noqa: E402

import torch_world  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
WORLDS = (2, 4)
#: The attention dropout rate of the reference GAT (its run.py), and the
#: keep share a few thousand draws hold it to.
DROPOUT, KEEP_TOL = 0.6, 0.05
LEAVES = ("int_senders", "int_receivers", "int_weight", "int_off", "int_cnt",
          "bnd_senders", "bnd_receivers", "bnd_weight", "bnd_off", "bnd_cnt",
          "send_idx", "int_tiles", "int_tile_col", "int_tile_row")
STATICS = ("n_nodes", "n_node_pad", "nodes_per_shard", "halo_size",
           "int_max_chunks", "bnd_max_chunks", "unit_edge_weights")


def _jmesh(d):
    return JMesh(np.array(jax.devices()[:d]), ("data",))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _graphs():
    """The cases' numpy inputs, from one seed (``tests/test_halo.py``'s
    shapes)."""
    rng = np.random.default_rng(42)
    g = {}
    n, e = 300, 2500
    g["plain"] = dict(s=rng.integers(0, n, e), r=rng.integers(0, n, e), n=n,
                      w=rng.random(e).astype(np.float32),
                      x=rng.normal(size=(n, 12)).astype(np.float32))
    n, comm, e = 1024, 128, 40000
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.9,
                 (s // comm) * comm + rng.integers(0, comm, e),
                 rng.integers(0, n, e))
    keep = s != r
    s, r = s[keep], r[keep]
    g["tiled"] = dict(s=s, r=r, n=n, w=rng.random(len(s)).astype(np.float32),
                      x=rng.normal(size=(n, 16)).astype(np.float32))
    n, comm, e = 768, 128, 20000
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) < 0.9,
                 (s // comm) * comm + rng.integers(0, comm, e),
                 rng.integers(0, n, e))
    keep = s != r
    g["attend"] = dict(s=s[keep], r=r[keep], n=n, heads=3, feat=8)
    a = g["attend"]
    a.update(h=rng.normal(size=(n, 3, 8)).astype(np.float32),
             fs=rng.normal(size=(n, 3)).astype(np.float32),
             fd=rng.normal(size=(n, 3)).astype(np.float32),
             c=rng.normal(size=(n, 24)).astype(np.float32),
             x=rng.normal(size=(n, 12)).astype(np.float32))
    s = rng.integers(0, n, 8000)
    r = (s // comm) * comm + rng.integers(0, comm // 2, 8000)
    keep = s != r
    g["indeg0"] = dict(s=s[keep], r=r[keep], n=n,
                       x=rng.normal(size=(n, 8)).astype(np.float32) - 5.0)
    n, e = 96, 700
    g["gat"] = dict(s=rng.integers(0, n, e), r=rng.integers(0, n, e), n=n,
                    x=rng.standard_normal((n, 12)).astype(np.float32),
                    w=(rng.standard_normal((12, 15)) * 0.3).astype(np.float32),
                    a_src=(rng.standard_normal((3, 5)) * 0.3).astype(
                        np.float32),
                    a_dst=(rng.standard_normal((3, 5)) * 0.3).astype(
                        np.float32))
    n, e = 384, 2500
    g["conv"] = dict(s=rng.integers(0, n, e), r=rng.integers(0, n, e), n=n,
                     x=rng.normal(size=(n, 16)).astype(np.float32))
    n = 64
    g["han"] = dict(edges=[(rng.integers(0, n, 400), rng.integers(0, n, 400))
                           for _ in range(2)], n=n,
                    x=rng.normal(size=(n, 12)).astype(np.float32),
                    labels=rng.integers(0, 3, n).astype(np.int64),
                    idx=np.concatenate([np.arange(0, 20), np.arange(40, 50)]))
    n, comm, e = 2048, 256, 40000
    shuffle = rng.permutation(n)
    s0 = rng.integers(0, n, e)
    r0 = np.where(rng.random(e) < 0.95,
                  (s0 // comm) * comm + rng.integers(0, comm, e),
                  rng.integers(0, n, e))
    keep = s0 != r0
    s = shuffle[s0[keep]].astype(np.int64)
    g["clustered"] = dict(s=s, r=shuffle[r0[keep]].astype(np.int64), n=n,
                          w=rng.random(len(s)).astype(np.float32),
                          x=rng.normal(size=(n, 8)).astype(np.float32))
    return g


def _rows(results, key):
    return np.concatenate([res[key] for res in results])


def _j_spmm_case(g, mesh, tiled, min_edges, op):
    hg = j_part(g["s"], g["r"], g["n"], g.get("w"), mesh=mesh,
                tiled_interior=tiled, min_edges_per_tile=min_edges)
    fn = j_spmm_halo if op == "spmm" else j_segmax_halo
    n = g["n"]
    out, grad = jax.jit(lambda xx: (fn(hg, xx), jax.grad(
        lambda x2: jnp.sum(jnp.tanh(fn(hg, x2))[:n]))(xx)))(
            j_shard(g["x"], hg))
    return {"out": np.asarray(out)[:n], "grad": np.asarray(grad)[:n]}


def _jax_side(g, d):
    """JAX's partitioned results on ``d`` virtual devices, the flax
    parameters of the layers, and the port world's cases."""
    mesh = _jmesh(d)
    ref, cases = {}, []
    key = jax.random.PRNGKey(0)
    for name, gk, tiled, min_e, op in (
            ("spmm", "plain", False, 192, "spmm"),
            ("spmm_tiled", "tiled", True, 32, "spmm"),
            ("segmax", "plain", False, 192, "max"),
            ("segmax_tiled", "attend", True, 16, "max"),
            ("segmax_indeg0", "indeg0", True, 16, "max")):
        gg = g[gk]
        ref[name] = _j_spmm_case(gg, mesh, tiled, min_e, op)
        cases.append((name, "spmm", dict(
            s=gg["s"], r=gg["r"], n=gg["n"], w=gg.get("w"), x=gg["x"],
            tiled=tiled, min_edges=min_e, op=op)))

    gg = g["gat"]
    hg = j_part(gg["s"], gg["r"], gg["n"], mesh=mesh)
    xs = j_shard(gg["x"], hg)
    a_s, a_d = jnp.asarray(gg["a_src"]), jnp.asarray(gg["a_dst"])
    n = gg["n"]

    def gat_loss(w, xx):
        return (j_gat_halo(hg, xx, w, a_s, a_d)[:n] ** 2).mean()

    out, (gw, gx) = jax.jit(lambda w, xx: (
        j_gat_halo(hg, xx, w, a_s, a_d),
        jax.grad(gat_loss, argnums=(0, 1))(w, xx)))(jnp.asarray(gg["w"]), xs)
    ref["gat_halo"] = {"out": np.asarray(out)[:n], "grad_w": np.asarray(gw),
                       "grad_x": np.asarray(gx)[:n]}
    cases.append(("gat_halo", "gat_halo", {
        k: gg[k] for k in ("s", "r", "n", "x", "w", "a_src", "a_dst")}))

    gg = g["attend"]
    n, heads, feat = gg["n"], gg["heads"], gg["feat"]
    hg = j_part(gg["s"], gg["r"], n, mesh=mesh, tiled_interior=True,
                min_edges_per_tile=16)
    hp = j_shard(gg["h"].reshape(n, -1), hg).reshape(
        hg.n_node_pad, heads, feat)
    fsp, fdp = j_shard(gg["fs"], hg), j_shard(gg["fd"], hg)
    c = jnp.asarray(gg["c"])

    def attend_loss(a, b, e):
        return jnp.sum(j_attend(hg, a, b, e)[:n] * c)

    out, grads = jax.jit(lambda a, b, e: (
        j_attend(hg, a, b, e),
        jax.grad(attend_loss, argnums=(0, 1, 2))(a, b, e)))(hp, fsp, fdp)
    ref["gat_tiled"] = {
        "out": np.asarray(out)[:n],
        "grad_h": np.asarray(grads[0])[:n], "grad_fs": np.asarray(grads[1])[:n],
        "grad_fd": np.asarray(grads[2])[:n]}
    cases.append(("gat_tiled", "gat_attend", {
        k: gg[k] for k in ("s", "r", "n", "h", "fs", "fd", "c")}))

    gg = g["conv"]
    n = gg["n"]
    g1 = j_build(gg["s"].astype(np.int32), gg["r"].astype(np.int32), n)
    hg = j_part(gg["s"], gg["r"], n, mesh=mesh)
    xs = j_shard(gg["x"], hg)
    layers = {"gatconv": (JGATConv(features=4, num_heads=2,
                                   attn_dropout=DROPOUT),
                          "GATConv", dict(features=4, num_heads=2,
                                          attn_dropout=DROPOUT))}
    for aggr in ("sum", "mean", "max"):
        layers[f"sage_{aggr}"] = (JSAGEConv(features=6, aggregator=aggr),
                                  "SAGEConv", dict(features=6,
                                                   aggregator=aggr))
    for name, (jm, layer, kw) in layers.items():
        params = jm.init(key, g1, jnp.asarray(gg["x"]))["params"]

        def conv_loss(p, xx):
            return (jm.apply({"params": p}, hg, xx)[:n] ** 2).mean()

        out, (gp, gx) = jax.jit(lambda p, xx: (
            jm.apply({"params": p}, hg, xx),
            jax.grad(conv_loss, argnums=(0, 1))(p, xx)))(params, xs)
        ref[name] = {"out": np.asarray(out)[:n],
                     "single": np.asarray(jax.jit(
                         lambda p: jm.apply({"params": p}, g1, jnp.asarray(
                             gg["x"])))(params)),
                     "grad_x": np.asarray(gx)[:n],
                     "grads": {k: v.numpy()
                               for k, v in from_flax(_np(gp)).items()}}
        state = {k: v.numpy() for k, v in from_flax(_np(params)).items()}
        cases.append((name, "conv", dict(
            s=gg["s"], r=gg["r"], n=n, x=gg["x"], state=state, layer=layer,
            kw=kw, dropout_runs=2 if layer == "GATConv" else 0)))

    gg = g["han"]
    n = gg["n"]
    graphs1 = [j_build(s.astype(np.int32), r.astype(np.int32), n)
               for s, r in gg["edges"]]
    jm = JHAN(num_metapaths=2, num_classes=3, hidden=4, num_heads=(2,),
              dropout=0.0)
    params = jm.init(key, graphs1, jnp.asarray(gg["x"]))["params"]
    hgs = [j_part(s, r, n, mesh=mesh) for s, r in gg["edges"]]
    xs = j_shard(gg["x"], hgs[0])
    idx, labels = jnp.asarray(gg["idx"]), jnp.asarray(gg["labels"])

    def han_loss(p):
        logits = jm.apply({"params": p}, hgs, xs)
        return j_ce(logits[idx], labels[idx]), logits

    (loss, logits), gp = jax.jit(jax.value_and_grad(
        han_loss, has_aux=True))(params)
    ref["han"] = {"logits": np.asarray(logits)[:n], "loss": float(loss),
                  "single": np.asarray(jax.jit(lambda p: jm.apply(
                      {"params": p}, graphs1, jnp.asarray(gg["x"])))(params)),
                  "grads": {k: v.numpy()
                            for k, v in from_flax(_np(gp)).items()}}
    cases.append(("han", "han", dict(
        edges=gg["edges"], n=n, x=gg["x"],
        state={k: v.numpy() for k, v in from_flax(_np(params)).items()},
        kw=dict(num_metapaths=2, num_classes=3, hidden=4, num_heads=(2,),
                dropout=0.0), labels=gg["labels"], idx=gg["idx"])))
    return ref, cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """For each D: (JAX's results, the port world's per-rank results)."""
    g = _graphs()
    out = {}
    for d in WORLDS:
        ref, cases = _jax_side(g, d)
        res = torch_world.run_world(tmp_path_factory.mktemp(f"halo{d}"), d,
                                    cases)
        out[d] = (ref, res)
    return g, out


# ---------------------------------------------------------------------------
# host arrays
# ---------------------------------------------------------------------------


def _assert_same_partition(t, j):
    for leaf in LEAVES:
        a, b = getattr(t, leaf), getattr(j, leaf)
        if b is None:
            assert a is None, leaf
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, leaf
        np.testing.assert_array_equal(a, b, err_msg=leaf)
    for s in STATICS:
        assert getattr(t, s) == getattr(j, s), s


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("case,tiled,min_edges,weighted", [
    ("plain", False, 192, True), ("plain", False, 192, False),
    ("tiled", True, 32, True), ("attend", True, 16, False)])
def test_partition_arrays_equal_jax(d, case, tiled, min_edges, weighted):
    g = _graphs()[case]
    w = g.get("w") if weighted else None
    t = partition_graph_halo(g["s"], g["r"], g["n"], w,
                             mesh=Mesh.layout(d),
                             tiled_interior=tiled,
                             min_edges_per_tile=min_edges)
    j = j_part(g["s"], g["r"], g["n"], w, mesh=_jmesh(d),
               tiled_interior=tiled, min_edges_per_tile=min_edges)
    _assert_same_partition(t, j)
    if tiled:
        assert sum(t.n_tiles) > 0
    assert boundary_edge_fraction(t) == j_bfrac(j)


@pytest.mark.parametrize("d", WORLDS)
def test_clustered_partition_equals_jax_and_cuts_boundary(d):
    """``partition_graph_halo_clustered`` on a community graph with
    shuffled ids: the same permutation and arrays as JAX's, a boundary
    fraction well below the naive partition's, and every rank's local
    step (its halo slab built from the whole array) on the permuted
    features equal to the single-device SpMM."""
    g = _graphs()["clustered"]
    mesh = Mesh.layout(d)
    hg, perm = partition_graph_halo_clustered(g["s"], g["r"], g["n"], g["w"],
                                              mesh=mesh)
    jhg, jperm = j_part_clustered(g["s"], g["r"], g["n"], g["w"],
                                  mesh=_jmesh(d))
    np.testing.assert_array_equal(perm, jperm)
    _assert_same_partition(hg, jhg)
    naive = partition_graph_halo(g["s"], g["r"], g["n"], g["w"], mesh=mesh)
    assert boundary_edge_fraction(hg) < boundary_edge_fraction(naive) / 3
    assert hg.int_tiles is not None
    x_full = torch.from_numpy(pad_rows(g["x"][perm], hg.n_node_pad))
    nps = hg.nodes_per_shard
    out = torch.cat([
        spmm_halo_local(hg.shard(k, "cpu"), x_full[k * nps:(k + 1) * nps],
                        halo_slab(x_full, hg, k)) for k in range(d)])
    ref = spmm(build_graph(g["s"], g["r"], g["n"], g["w"], device="cpu"),
               torch.from_numpy(g["x"]))
    inv = invert_permutation(perm)
    np.testing.assert_allclose(out.numpy()[:g["n"]][inv], ref.numpy(),
                               **F32_TOL)


def test_halo_traffic_smaller_than_allgather():
    """The exchange plan moves fewer rows than a full all-gather on a
    clustered graph (8 ranks, host only)."""
    rng = np.random.default_rng(3)
    n, per = 1024, 128
    s = [rng.integers(0, per, 600) + c * per for c in range(8)]
    r = [rng.integers(0, per, 600) + c * per for c in range(8)]
    s.append(rng.integers(0, n, 100))
    r.append(rng.integers(0, n, 100))
    s, r = np.concatenate(s), np.concatenate(r)
    hg = partition_graph_halo(s, r, n, mesh=Mesh.layout(8))
    assert (hg.n_devices * hg.n_devices * hg.halo_size
            < hg.n_devices * hg.n_node_pad / 3)
    _assert_same_partition(hg, j_part(s, r, n, mesh=_jmesh(8)))


def test_halo_weak_scaling_traffic_model():
    """The exchange's bytes a rank stay a small share of its memory bytes
    as ranks are added (2, 4, 8 ranks at 4,096 nodes a rank, 5 % cross
    edges), and grow less than the rank count."""
    rng = np.random.default_rng(4)
    f, cross, ratios = 128, 0.05, []
    for nd in (2, 4, 8):
        n, e = 4096 * nd, 32768 * nd
        per = n // nd
        part = rng.integers(0, nd, e)
        r = part * per + rng.integers(0, per, e)
        s_part = np.where(rng.random(e) < cross, rng.integers(0, nd, e),
                          part)
        s = s_part * per + rng.integers(0, per, e)
        hg = partition_graph_halo(s, r, n, mesh=Mesh.layout(nd))
        assert int((hg.bnd_weight != 0).sum()) / e <= 2 * cross
        ici = (nd - 1) * hg.halo_size * f * 4
        hbm = (e // nd) * (f * 4 + 12) + 2 * hg.nodes_per_shard * f * 4
        ratios.append(ici / hbm)
    assert all(rt < 0.5 for rt in ratios), ratios
    assert ratios[-1] < 4 * ratios[0], ratios


# ---------------------------------------------------------------------------
# the worlds against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("case", ["spmm", "spmm_tiled", "segmax",
                                  "segmax_tiled", "segmax_indeg0"])
def test_spmm_and_segment_max_match_jax(worlds, d, case):
    g, out = worlds
    ref, res = out[d]
    n = ref[case]["out"].shape[0]
    np.testing.assert_allclose(_rows([r[case] for r in res], "out")[:n],
                               ref[case]["out"], **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("case", ["spmm", "spmm_tiled", "segmax",
                                  "segmax_tiled"])
def test_spmm_and_segment_max_grads_match_jax(worlds, d, case):
    g, out = worlds
    ref, res = out[d]
    n = ref[case]["grad"].shape[0]
    np.testing.assert_allclose(_rows([r[case] for r in res], "grad")[:n],
                               ref[case]["grad"], **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("case,gk,op", [("spmm", "plain", "spmm"),
                                        ("spmm_tiled", "tiled", "spmm"),
                                        ("segmax", "plain", "max"),
                                        ("segmax_tiled", "attend", "max")])
def test_one_vs_n_spmm_and_segment_max(worlds, d, case, gk, op):
    """The ranks' rows against the port's own single-device op."""
    g, out = worlds
    gg = g[gk]
    graph = build_graph(gg["s"], gg["r"], gg["n"],
                        gg.get("w") if op == "spmm" else None, device="cpu")
    x = torch.from_numpy(gg["x"])
    single = (spmm(graph, x) if op == "spmm" else
              segment_max(x[graph.senders.long()], graph.receivers.long(),
                          graph.n_nodes, mask=graph.edge_mask))
    n = gg["n"]
    np.testing.assert_allclose(
        _rows([r[case] for r in out[d][1]], "out")[:n], single.numpy(),
        **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
def test_tiled_segment_max_indegree_zero_nodes(worlds, d):
    g, out = worlds
    gg = g["indeg0"]
    n = gg["n"]
    got = _rows([r["segmax_indeg0"] for r in out[d][1]], "out")[:n]
    indeg = np.bincount(gg["r"], minlength=n)
    assert (indeg == 0).any()
    np.testing.assert_array_equal(got[indeg == 0], 0.0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["out", "grad_x"])
def test_gat_halo_matches_jax(worlds, d, key):
    ref, res = worlds[1][d]
    n = ref["gat_halo"][key].shape[0]
    np.testing.assert_allclose(_rows([r["gat_halo"] for r in res], key)[:n],
                               ref["gat_halo"][key], **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
def test_gat_halo_weight_grad_matches_jax(worlds, d):
    ref, res = worlds[1][d]
    for r in res:   # summed over the ranks: the same on each
        np.testing.assert_allclose(r["gat_halo"]["grad_w"],
                                   ref["gat_halo"]["grad_w"], **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["out", "grad_h", "grad_fs", "grad_fd"])
def test_tiled_partition_gat_matches_jax(worlds, d, key):
    ref, res = worlds[1][d]
    assert any(r["gat_tiled"]["tiles"] for r in res)
    want = ref["gat_tiled"][key]
    got = _rows([r["gat_tiled"] for r in res], key)[:want.shape[0]]
    np.testing.assert_allclose(got.reshape(want.shape), want, **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("layer", ["gatconv", "sage_sum", "sage_mean",
                                   "sage_max"])
def test_conv_layers_on_halo_graph_match_jax(worlds, d, layer):
    """Forward rows (against JAX's halo run and its single-device layer),
    the gradient of this rank's rows of ``x`` and every parameter's
    gradient summed over the ranks."""
    ref, res = worlds[1][d]
    want = ref[layer]
    n = want["out"].shape[0]
    got = _rows([r[layer] for r in res], "out")[:n]
    np.testing.assert_allclose(got, want["out"], **F32_TOL)
    np.testing.assert_allclose(got, want["single"], **F32_TOL)
    np.testing.assert_allclose(_rows([r[layer] for r in res], "grad_x")[:n],
                               want["grad_x"], **F32_TOL)
    for r in res:
        assert sorted(r[layer]["grads"]) == sorted(want["grads"])
        for k, gk in want["grads"].items():
            np.testing.assert_allclose(r[layer]["grads"][k], gk,
                                       err_msg=k, **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
def test_gatconv_attention_dropout(worlds, d):
    """Attention dropout on the halo branch: each rank's own generator,
    numerators kept at the keep rate, outputs finite and unlike the
    deterministic layer; two draws differ. At rate 0 the layer is exact
    (``test_conv_layers_on_halo_graph_match_jax``)."""
    ref, res = worlds[1][d]
    n = ref["gatconv"]["out"].shape[0]
    first = np.concatenate([r["gatconv"]["dropped"][0] for r in res])[:n]
    second = np.concatenate([r["gatconv"]["dropped"][1] for r in res])[:n]
    assert np.isfinite(first).all()
    assert not np.allclose(first, ref["gatconv"]["out"])
    assert not np.allclose(first, second)
    kept = [r["gatconv"]["kept_share"] for r in res
            if r["gatconv"]["kept_share"] > 0]
    assert kept and all(abs(k - (1 - DROPOUT)) < KEEP_TOL for k in kept)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["logits", "loss", "grads"])
def test_han_on_halo_metapath_graphs_matches_jax(worlds, d, key):
    """HAN on halo graphs: the semantic attention's mean over every rank's
    rows (the padding masked), the loss over training rows split unevenly
    over the ranks, and the summed gradients."""
    ref, res = worlds[1][d]
    want = ref["han"]
    if key == "logits":
        n = want["logits"].shape[0]
        got = _rows([r["han"] for r in res], "logits")[:n]
        np.testing.assert_allclose(got, want["logits"], **F32_TOL)
        np.testing.assert_allclose(got, want["single"], **F32_TOL)
    elif key == "loss":
        for r in res:
            np.testing.assert_allclose(r["han"]["loss"], want["loss"],
                                       **F32_TOL)
    else:
        for r in res:
            for k, gk in want["grads"].items():
                np.testing.assert_allclose(r["han"]["grads"][k], gk,
                                           err_msg=k, **F32_TOL)


# ---------------------------------------------------------------------------
# in one process: each rank's step from a slab built from the whole array
# ---------------------------------------------------------------------------


def test_local_steps_from_built_slabs_match_single_device():
    """``spmm_halo_local``, ``segment_max_local`` and ``attend_local`` of
    every rank of a 4-way tiled partition, each given the halo slab built
    by ``halo_slab`` from the whole padded array, concatenate to the
    single-device SpMM, segment max and edge-softmax attention (what
    ``chip_smoke.py`` runs on the card)."""
    g = _graphs()["attend"]
    n, heads, feat = g["n"], g["heads"], g["feat"]
    hg = partition_graph_halo(g["s"], g["r"], n,
                              mesh=Mesh.layout(4),
                              tiled_interior=True, min_edges_per_tile=16)
    nps = hg.nodes_per_shard
    x = torch.from_numpy(pad_rows(g["x"], hg.n_node_pad))
    h = torch.from_numpy(pad_rows(g["h"], hg.n_node_pad))
    fs = torch.from_numpy(pad_rows(g["fs"], hg.n_node_pad))
    fd = torch.from_numpy(pad_rows(g["fd"], hg.n_node_pad))
    payload = torch.cat([h.reshape(-1, heads * feat), fs], dim=1)
    sums, maxes, att = [], [], []
    for k in range(4):
        sh = hg.shard(k, "cpu")
        rows = slice(k * nps, (k + 1) * nps)
        sums.append(spmm_halo_local(sh, x[rows], halo_slab(x, hg, k)))
        maxes.append(segment_max_local(sh, x[rows], halo_slab(x, hg, k)))
        att.append(attend_local(sh, h[rows], fs[rows], fd[rows],
                                halo_slab(payload, hg, k)))
    graph = build_graph(g["s"], g["r"], n, device="cpu")
    xs = torch.from_numpy(g["x"])
    np.testing.assert_allclose(torch.cat(sums)[:n].numpy(),
                               spmm(graph, xs).numpy(), **F32_TOL)
    np.testing.assert_allclose(
        torch.cat(maxes)[:n].numpy(),
        segment_max(xs[graph.senders.long()], graph.receivers.long(), n,
                    mask=graph.edge_mask).numpy(), **F32_TOL)
    from graphneuralnetwork_tpu_torch.ops.segment import edge_softmax
    from graphneuralnetwork_tpu_torch.ops.spmm import spmm_weighted
    t = [torch.from_numpy(g[k]) for k in ("h", "fs", "fd")]
    sc = torch.nn.functional.leaky_relu(
        t[1][graph.senders.long()] + t[2][graph.receivers.long()], 0.2)
    ref = spmm_weighted(graph, edge_softmax(graph, sc), t[0])
    np.testing.assert_allclose(torch.cat(att)[:n].numpy(),
                               ref.reshape(n, -1).numpy(), **F32_TOL)


def test_gat_halo_attend_rejects_weighted_tiles():
    """A tiled partition built with non-unit weights refuses attention
    instead of computing a weighted softmax."""
    g = _graphs()["attend"]
    rng = np.random.default_rng(5)
    w = (rng.random(len(g["s"])) + 0.5).astype(np.float32)
    mesh = Mesh.layout(4)
    hg_w = partition_graph_halo(g["s"], g["r"], g["n"], w, mesh=mesh,
                                tiled_interior=True, min_edges_per_tile=16)
    hg = partition_graph_halo(g["s"], g["r"], g["n"], mesh=mesh,
                              tiled_interior=True, min_edges_per_tile=16)
    assert not hg_w.unit_edge_weights and hg.unit_edge_weights
    sh = hg_w.shard(0, "cpu")
    nps = hg_w.nodes_per_shard
    h, f = torch.zeros(nps, 2, 4), torch.zeros(nps, 2)
    slab = torch.zeros(4 * hg_w.halo_size, 10)
    with pytest.raises(ValueError, match="unit"):
        attend_local(sh, h, f, f, slab)


# ---------------------------------------------------------------------------
# a graph whose sender table is larger than its receivers
# ---------------------------------------------------------------------------


def test_rectangular_graph_matches_index_add():
    """A boundary-shaped ``Graph`` (senders index a table of more rows
    than it has receivers, ``n_senders``): K1's gathered form and the
    sender gather, forward and backward, against ``index_add_``."""
    rng = np.random.default_rng(6)
    n_recv, n_send, e = 40, 96, 300
    s, r = rng.integers(0, n_send, e), rng.integers(0, n_recv, e)
    w = rng.random(e).astype(np.float32)
    g = dataclasses.replace(build_graph(s, r, n_recv, w, device="cpu"),
                            n_senders=n_send)
    assert g.transpose.row_ptr.shape == (n_send + 1,)
    x = torch.from_numpy(rng.normal(size=(n_send, 5)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(n_recv, 5)).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    out = aggregate_gathered(g, xa, g.edge_weight)
    (out * c).sum().backward()
    xb = x.clone().requires_grad_(True)
    sr, rr = torch.from_numpy(s), torch.from_numpy(r)
    ref = torch.zeros(n_recv, 5).index_add_(
        0, rr, xb[sr] * torch.from_numpy(w)[:, None])
    (ref * c).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **F32_TOL)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), **F32_TOL)
    ta = x.clone().requires_grad_(True)
    (gather_senders(g, ta)[:e] * c[g.receivers[:e].long()]).sum().backward()
    tb = torch.zeros(n_send, 5).index_add_(0, sr, c[rr])
    np.testing.assert_allclose(ta.grad.numpy(), tb.numpy(), **F32_TOL)
