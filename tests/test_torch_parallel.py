"""The all-gather partition (``parallel/sharded.py``) and the data-parallel
step (``parallel/dp.py``, ``train/embed_loop.py``) of the PyTorch port
against the JAX package on the CPU.

Host arrays: ``partition_graph`` byte-equal to JAX's for D = 2 and 4. A
gloo world of D spawned processes (``torch_world.py``, only the port) runs
``spmm_sharded`` forward and gradient, the GCN training step on the
sharded Cora graph (loss, gradients and the loss after one Adam step), a
DP skip-gram step, a GCN step on a tiled halo partition whose training
rows split unevenly over the ranks, and the port's dry run
(``parallel/dryrun.py``, which holds every phase against the
single-device model itself; also at D = 1 in this process). JAX runs on
the first D devices of conftest's virtual mesh from the same numpy inputs
and flax parameters.
Tolerance ``F32_TOL`` (float32 sums in other orders). Each world is
spawned once for the module. The cases mirror ``tests/test_parallel.py``'s
data-parallel and all-gather cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.sharding import Mesh as JMesh  # noqa: E402

from graphneuralnetwork_tpu.data import load_cora as j_load_cora  # noqa: E402
from graphneuralnetwork_tpu.nn import GCN as JGCN  # noqa: E402
from graphneuralnetwork_tpu.nn.embed import SkipGram as JSkipGram  # noqa: E402
from graphneuralnetwork_tpu.ops import spmm as j_spmm  # noqa: E402
from graphneuralnetwork_tpu.parallel import (  # noqa: E402
    partition_graph as j_part, shard_nodes as j_shard)
from graphneuralnetwork_tpu.train.embed_loop import (  # noqa: E402
    make_skipgram_step as j_skipgram_step, shard_batch_arrays as j_shard_batch)
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    add_self_loops, build_graph, sym_normalize_weights, symmetrize)
from graphneuralnetwork_tpu_torch.data.planetoid import (  # noqa: E402
    synthetic_citation_graph)
from graphneuralnetwork_tpu_torch.nn import GCN  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.spmm import spmm  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel import (  # noqa: E402
    Mesh, partition_graph)
from graphneuralnetwork_tpu_torch.parallel.dp import owned_rows  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel import make_mesh  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel.dryrun import (  # noqa: E402
    PHASES, dryrun_multichip)
from graphneuralnetwork_tpu_torch.parallel.sharded import (  # noqa: E402
    nodes_per_shard)
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy)

import torch_world  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
WORLDS = (2, 4)
#: The uneven training rows of the halo GCN case: 100 on the first rank,
#: 20 further on (none on some ranks).
UNEVEN_IDX = np.concatenate([np.arange(0, 100), np.arange(260, 280)])


def _jmesh(d):
    return JMesh(np.array(jax.devices()[:d]), ("data",))


def _state(params):
    return {k: v.numpy()
            for k, v in from_flax(jax.tree.map(np.asarray, params)).items()}


def _spmm_inputs():
    rng = np.random.default_rng(42)
    n, e = 500, 3000
    return dict(s=rng.integers(0, n, e), r=rng.integers(0, n, e), n=n,
                w=rng.random(e).astype(np.float32),
                x=rng.normal(size=(n, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def cora():
    data = j_load_cora(seed=0)
    g = data.graph
    e = g.n_edges
    return dict(s=np.asarray(g.senders)[:e], r=np.asarray(g.receivers)[:e],
                w=np.asarray(g.edge_weight)[:e], n=data.features.shape[0],
                x=np.asarray(data.features), graph=g, data=data,
                labels=np.asarray(data.labels).astype(np.int64),
                idx=np.asarray(data.train_idx))


def _halo_gcn_inputs():
    """The dry run's tiny graph at 4 ranks' size, GCN-normalised."""
    feats, labels, s, r = synthetic_citation_graph(
        n_nodes=512, n_feats=32, n_classes=4, seed=0)
    n = feats.shape[0]
    s, r = add_self_loops(*symmetrize(s, r), n)
    return dict(s=s, r=r, n=n, w=sym_normalize_weights(s, r, n), x=feats,
                labels=labels.astype(np.int64))


def _jax_side(cora, d):
    mesh = _jmesh(d)
    ref, cases = {}, []
    g = _spmm_inputs()
    n = g["n"]
    sg = j_part(g["s"], g["r"], n, g["w"], mesh=mesh)
    out, grad = jax.jit(lambda xx: (j_spmm(sg, xx), jax.grad(
        lambda x2: jnp.sum(jnp.tanh(j_spmm(sg, x2))[:n]))(xx)))(
            j_shard(g["x"], sg))
    ref["spmm"] = {"out": np.asarray(out)[:n], "grad": np.asarray(grad)[:n]}
    cases.append(("spmm", "spmm", dict(kind="sharded", **g)))

    model = JGCN(hidden=16, num_classes=cora["data"].num_classes, dropout=0.0)
    params = model.init(jax.random.PRNGKey(0), cora["graph"],
                        cora["data"].features)["params"]
    sg = j_part(cora["s"], cora["r"], cora["n"], cora["w"], mesh=mesh)
    xs = j_shard(cora["x"], sg)
    labels, idx = cora["data"].labels, cora["data"].train_idx

    def loss_fn(p):
        logits = model.apply({"params": p}, sg, xs)
        return j_ce(logits[idx], labels[idx]), logits

    tx = optax.adam(1e-2)

    @jax.jit
    def step(p, o):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, o = tx.update(grads, o, p)
        p2 = optax.apply_updates(p, u)
        return loss, logits, grads, loss_fn(p2)[0]

    loss, logits, grads, loss2 = step(params, tx.init(params))
    ref["gcn"] = {"loss": float(loss), "logits": np.asarray(logits)[:cora["n"]],
                  "grads": _state(grads), "loss_after_step": float(loss2),
                  "single_loss": float(jax.jit(lambda p: j_ce(
                      model.apply({"params": p}, cora["graph"],
                                  cora["data"].features)[idx], labels[idx]))(
                                      params))}
    cases.append(("gcn", "gcn_step", dict(
        s=cora["s"], r=cora["r"], n=cora["n"], w=cora["w"], x=cora["x"],
        labels=cora["labels"], idx=cora["idx"], state=_state(params),
        hidden=16, kind="sharded")))

    rng = np.random.default_rng(7)
    vocab, b, c = 50, 64, 6
    jm = JSkipGram(vocab_size=vocab, embed_dim=8)
    arrays = (rng.integers(0, vocab, b).astype(np.int32),
              rng.integers(0, vocab, (b, c)).astype(np.int32),
              (rng.random((b, c)) < 0.5).astype(np.float32),
              (rng.random((b, c)) < 0.9).astype(np.float32))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(arrays[0]),
                     jnp.asarray(arrays[1]))["params"]
    tx = optax.adam(1e-2)
    p1, _, loss1, acc1 = j_skipgram_step(jm, tx)(
        params, tx.init(params), *j_shard_batch(arrays, mesh))
    ref["skipgram"] = {"loss": float(loss1), "acc": float(acc1),
                       "state": _state(p1)}
    cases.append(("skipgram", "skipgram", dict(
        vocab=vocab, dim=8, centers=arrays[0], ctx_neg=arrays[1],
        labels=arrays[2], mask=arrays[3], state=_state(params))))

    h = _halo_gcn_inputs()
    model = GCN(32, hidden=16, num_classes=4, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(3))
    cases.append(("halo_gcn", "gcn_step", dict(
        idx=UNEVEN_IDX, hidden=16, kind="halo", tiled=True, min_edges=8,
        state={k: v.numpy() for k, v in model.state_dict().items()}, **h)))
    cases.append(("dryrun", "dryrun", {}))
    return ref, cases


@pytest.fixture(scope="module")
def worlds(cora, tmp_path_factory):
    out = {}
    for d in WORLDS:
        ref, cases = _jax_side(cora, d)
        out[d] = (ref, torch_world.run_world(
            tmp_path_factory.mktemp(f"parallel{d}"), d, cases))
    return out


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("weighted", [True, False])
def test_partition_arrays_equal_jax(d, weighted):
    g = _spmm_inputs()
    w = g["w"] if weighted else None
    t = partition_graph(g["s"], g["r"], g["n"], w,
                        mesh=Mesh.layout(d))
    j = j_part(g["s"], g["r"], g["n"], w, mesh=_jmesh(d))
    for leaf in ("senders", "receivers", "edge_weight", "chunk_off",
                 "chunk_cnt"):
        a, b = getattr(t, leaf), np.asarray(getattr(j, leaf))
        assert a.dtype == b.dtype and a.shape == b.shape, leaf
        np.testing.assert_array_equal(a, b, err_msg=leaf)
    for s in ("n_nodes", "n_node_pad", "nodes_per_shard", "max_chunks"):
        assert getattr(t, s) == getattr(j, s), s
    assert t.n_devices == j.n_devices == d


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["out", "grad"])
def test_sharded_spmm_matches_jax(worlds, d, key):
    ref, res = worlds[d]
    want = ref["spmm"][key]
    got = np.concatenate([r["spmm"][key] for r in res])[:want.shape[0]]
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_spmm_one_vs_n(worlds, d):
    g = _spmm_inputs()
    single = spmm(build_graph(g["s"], g["r"], g["n"], g["w"], device="cpu"),
                  torch.from_numpy(g["x"]))
    got = np.concatenate([r["spmm"]["out"] for r in worlds[d][1]])
    np.testing.assert_allclose(got[:g["n"]], single.numpy(), **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["loss", "logits", "grads",
                                 "loss_after_step"])
def test_sharded_gcn_training_step_matches_jax(worlds, d, key):
    """The GCN step on the sharded Cora graph: the loss (also against
    JAX's single-device loss), logits, summed gradients and the loss after
    one Adam step."""
    ref, res = worlds[d]
    want = ref["gcn"]
    if key == "logits":
        got = np.concatenate([r["gcn"]["logits"] for r in res])
        np.testing.assert_allclose(got[:want["logits"].shape[0]],
                                   want["logits"], **F32_TOL)
    elif key == "grads":
        for r in res:
            assert sorted(r["gcn"]["grads"]) == sorted(want["grads"])
            for k, g in want["grads"].items():
                np.testing.assert_allclose(r["gcn"]["grads"][k], g,
                                           err_msg=k, **F32_TOL)
    else:
        for r in res:
            np.testing.assert_allclose(r["gcn"][key], want[key], **F32_TOL)
        if key == "loss":
            np.testing.assert_allclose(want["single_loss"], want["loss"],
                                       **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["loss", "acc", "state"])
def test_data_parallel_skipgram_step_matches_jax(worlds, d, key):
    """The batch's rows split over the ranks: the loss and accuracy of the
    whole batch and the tables after the step equal JAX's."""
    ref, res = worlds[d]
    for r in res:
        if key == "state":
            for k, v in ref["skipgram"]["state"].items():
                np.testing.assert_allclose(r["skipgram"]["state"][k], v,
                                           err_msg=k, **F32_TOL)
        else:
            np.testing.assert_allclose(r["skipgram"][key],
                                       ref["skipgram"][key], **F32_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["loss", "grads", "loss_after_step"])
def test_uneven_train_rows_equal_single_device(worlds, d, key):
    """Training rows split unevenly over the ranks (some hold none): the
    D-rank loss, summed gradients and the loss after one Adam step equal
    the port's single-device step: the loss is normalised by the global
    count of rows, not per rank."""
    h = _halo_gcn_inputs()
    counts = [len(owned_rows(torch.from_numpy(UNEVEN_IDX), k,
                             nodes_per_shard(h["n"], d)))
              for k in range(d)]
    assert len(set(counts)) > 1
    model = GCN(32, hidden=16, num_classes=4, dropout=0.0)
    model.reset_parameters(torch.Generator().manual_seed(3))
    graph = build_graph(h["s"], h["r"], h["n"], h["w"], device="cpu")
    x, y = torch.from_numpy(h["x"]), torch.from_numpy(h["labels"])
    idx = torch.from_numpy(UNEVEN_IDX)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)

    def loss_fn():
        return masked_softmax_cross_entropy(model(graph, x)[idx], y[idx])

    loss = loss_fn()
    loss.backward()
    want = {"loss": float(loss.detach()),
            "grads": {k: p.grad.numpy().copy()
                      for k, p in model.named_parameters()}}
    opt.step()
    want["loss_after_step"] = float(loss_fn().detach())
    for r in worlds[d][1]:
        got = r["halo_gcn"]
        if key == "grads":
            for k, g in want["grads"].items():
                np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                           **F32_TOL)
        else:
            np.testing.assert_allclose(got[key], want[key], **F32_TOL)


@pytest.fixture(scope="module")
def dryrun_one():
    """The dry run in this process: a world of 1 without a process group
    (its collectives the identity)."""
    reports = dryrun_multichip(make_mesh(device="cpu"))
    for rep in reports.values():
        rep.pop("step")
    return reports


@pytest.mark.parametrize("d", (1,) + WORLDS)
@pytest.mark.parametrize("phase", list(PHASES))
def test_dryrun_phases(request, d, phase):
    """Each dry-run phase ran on D ranks (the tensor-parallel ones on a
    2×2 mesh at D = 4, D×1 otherwise), matched the single-device step (it
    raises otherwise) and reports a finite loss."""
    if d == 1:
        rep = request.getfixturevalue("dryrun_one")[phase]
    else:
        rep = request.getfixturevalue("worlds")[d][1][0]["dryrun"][phase]
    assert rep["world"] == d
    assert np.isfinite(rep["loss"])
    assert all(e <= 1e-4 for e in rep["rel_err"].values())
    assert (phase == "walks") == (not rep["rel_err"])
