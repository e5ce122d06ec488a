"""GCN and full-batch GraphSAGE on the hybrid layout, the Pubmed loaders
and the CLI's new runs: the PyTorch port against the JAX package on the
CPU.

The same weights (``params.from_flax``), dropout off: logits and every
parameter gradient of ``GCN`` on the Cora hybrid and of ``GraphSAGE``
(``mean``, ``sum``, ``max``) on a clustered hybrid against flax, and the
port's hybrid against its own COO layout. Tolerances: ``F32_TOL`` and
``BF16_TOL`` of ``tests/test_torch_models.py`` (bfloat16 relative to the
largest logit and the largest gradient entry, as there). The max-pool
gradients agree because no tie carries a gradient here: the first layer's
input needs none, and the second layer's ties are between post-ReLU zeros,
whose gradient ReLU kills.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.data import load_cora as j_load_cora  # noqa: E402
from graphneuralnetwork_tpu.data import pubmed as jpubmed  # noqa: E402
from graphneuralnetwork_tpu.nn import GCN as JGCN  # noqa: E402
from graphneuralnetwork_tpu.nn import GraphSAGE as JSAGE  # noqa: E402
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch.cli import main  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import load_cora as t_load_cora  # noqa: E402
from graphneuralnetwork_tpu_torch.data import pubmed as tpubmed  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import GCN as TGCN  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import GraphSAGE as TSAGE  # noqa: E402
from graphneuralnetwork_tpu_torch.nn.conv import SAGEConv  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as t_ce)
from test_torch_bcsr import (  # noqa: E402
    assert_graph_equal, assert_hybrid_equal)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
N_TRAIN = 60


def _run_both(jm, tm, jgraph_, tgraph_, x, labels, train):
    """Logits, loss and parameter gradients of the flax model and of the
    port's model loaded with the same weights."""
    params = jm.init(jax.random.PRNGKey(0), jgraph_, jnp.asarray(x))[
        "params"]

    def jloss(p):
        logits = jm.apply({"params": p}, jgraph_, jnp.asarray(x))
        return j_ce(logits[train], jnp.asarray(labels)[train]), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tm.eval()
    tlogits = tm(tgraph_, torch.from_numpy(x))
    t_ce(tlogits[train], torch.from_numpy(labels.astype(np.int64))[train]
         ).backward()
    tgrads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    jgrads = {k: v.numpy() for k, v in
              from_flax(jax.tree.map(np.asarray, jgrads)).items()}
    assert sorted(tgrads) == sorted(jgrads)
    return np.asarray(jlogits), jgrads, tlogits.detach().numpy(), tgrads


def _assert_close(jlogits, jgrads, tlogits, tgrads, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(tlogits, jlogits, **F32_TOL)
        for name, g in jgrads.items():
            np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                       **F32_TOL)
        return
    scale = float(np.abs(jlogits).max())
    np.testing.assert_allclose(tlogits / scale, jlogits / scale, **BF16_TOL)
    gs = max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name] / gs, g / gs, err_msg=name,
                                   **BF16_TOL)


@pytest.fixture(scope="module")
def cora_hybrid():
    return (j_load_cora(seed=0, layout="hybrid"),
            t_load_cora(seed=0, layout="hybrid", device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_on_cora_hybrid_matches_flax(dtype, cora_hybrid):
    """GCN on the sym-normalised Cora hybrid (K3 on its tiles, K1 on the
    remainder); in bfloat16 the float32 tiles round to bfloat16 on both
    sides."""
    j, t = cora_hybrid
    jd, td = ((None, None) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    x = np.asarray(j.features)
    labels = np.asarray(j.labels)
    train = np.asarray(j.train_idx)
    out = _run_both(JGCN(hidden=16, num_classes=j.num_classes, dtype=jd),
                    TGCN(x.shape[1], hidden=16, num_classes=j.num_classes,
                         dtype=td),
                    j.graph, t.graph, x, labels, train)
    assert out[2].dtype == np.float32
    _assert_close(*out, dtype)


def _clustered(n=640, comm=128, e=6000, inter=0.15, seed=0):
    """The JAX package's SAGE fixture graph
    (``tests/test_bcsr_attention.py:_clustered_graph``), symmetrised."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    base = (s // comm) * comm
    r = np.where(rng.random(e) >= inter, base + rng.integers(0, comm, e),
                 rng.integers(0, n, e))
    keep = s != r
    return jgraph.symmetrize(s[keep].astype(np.int32),
                             r[keep].astype(np.int32))


@pytest.fixture(scope="module")
def sage_data():
    n, c = 640, 16
    s, r = _clustered()
    jh = jbcsr.build_hybrid(s, r, n, min_edges_per_tile=192, symmetric=True)
    th = tbcsr.build_hybrid(s, r, n, min_edges_per_tile=192, symmetric=True,
                            device="cpu")
    coo = tgraph.build_graph(s, r, n, device="cpu")
    assert th.tiled_fraction > 0.5 and th.rem.n_edges > 0
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, c)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    return jh, th, coo, x, labels


SAGE_CASES = [("mean", "float32"), ("sum", "float32"), ("max", "float32"),
              ("mean", "bfloat16"), ("sum", "bfloat16")]


@pytest.mark.parametrize("aggregator,dtype", SAGE_CASES)
def test_graphsage_on_hybrid_matches_flax(aggregator, dtype, sage_data):
    jh, th, _, x, labels = sage_data
    jd, td = ((None, None) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    out = _run_both(
        JSAGE(hidden_dims=(8,), num_classes=3, aggregator=aggregator,
              dtype=jd),
        TSAGE(x.shape[1], hidden_dims=(8,), num_classes=3,
              aggregator=aggregator, dtype=td),
        jh, th, x, labels, np.arange(N_TRAIN))
    assert sorted(out[3]) == ["sage0.neighbor.weight", "sage0.self.weight",
                              "sage_out.neighbor.weight",
                              "sage_out.self.weight"]
    _assert_close(*out, dtype)


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_graphsage_hybrid_matches_coo(aggregator, sage_data):
    """The same model and weights on the hybrid and on the COO layout of
    the same edges: logits and gradients."""
    _, th, coo, x, labels = sage_data
    results = []
    for graph in (th, coo):
        m = TSAGE(x.shape[1], hidden_dims=(8,), num_classes=3,
                  aggregator=aggregator)
        m.reset_parameters(torch.Generator().manual_seed(5))
        logits = m(graph, torch.from_numpy(x))
        t_ce(logits[:N_TRAIN], torch.from_numpy(
            labels[:N_TRAIN].astype(np.int64))).backward()
        results.append((logits.detach().numpy(),
                        {k: p.grad.numpy() for k, p in m.named_parameters()}))
    (lh, gh), (lc, gc) = results
    np.testing.assert_allclose(lh, lc, **F32_TOL)
    for name in gh:
        np.testing.assert_allclose(gh[name], gc[name], err_msg=name,
                                   **F32_TOL)


def test_sage_init_is_flax_lecun_normal():
    """``reset_parameters`` draws flax's Dense default, ``lecun_normal``
    (variance 1/fan_in, truncated at two standard deviations), not
    glorot: the sample's spread and bounds match."""
    layer = SAGEConv(500, 256, use_bias=True)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    w = layer.neighbor.weight.detach().numpy()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (500, 256)))
    np.testing.assert_allclose(w.std(), ref.std(), rtol=0.02)
    bound = 2 * np.sqrt(1 / 500) / 0.87962566103423978
    assert np.abs(w).max() <= bound and np.abs(ref).max() <= bound
    assert not layer.neighbor.bias.detach().numpy().any()


def test_load_pubmed_arrays_equal_jax():
    j, t = jpubmed.load_pubmed(seed=0), tpubmed.load_pubmed(seed=0)
    for name in ("features", "labels", "senders", "receivers", "train_idx",
                 "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert t.num_classes == j.num_classes == 3


@pytest.mark.parametrize("layout", ["hybrid", "auto", "coo"])
def test_load_pubmed_fullbatch_equals_jax(layout):
    """The same layout decision, graph arrays, relabelling and splits; the
    hybrid's tiles are dense from 64 edges on, and ``auto`` keeps this
    graph on COO, as in JAX."""
    j = jpubmed.load_pubmed_fullbatch(seed=0, layout=layout)
    t = tpubmed.load_pubmed_fullbatch(seed=0, layout=layout, device="cpu")
    assert hasattr(t.graph, "bcsr") == hasattr(j.graph, "bcsr") == (
        layout == "hybrid")
    if layout == "hybrid":
        assert_hybrid_equal(t.graph, j.graph)
        assert t.graph.symmetric and t.graph.bcsr.max_tiles == 6
    else:
        assert_graph_equal(t.graph, j.graph, "graph")
    np.testing.assert_array_equal(t.features.numpy(), np.asarray(j.features))
    for name in ("labels", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    np.testing.assert_array_equal(t.raw_senders, j.raw_senders)
    assert t.num_classes == j.num_classes


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_cli_graphsage_hybrid_trains_on_cpu(aggregator):
    res = main(["--model", "graphsage", "--layout", "hybrid", "--epochs",
                "3", "--set", f"aggregator={aggregator}", "--set", "lr=0.02",
                "--device", "cpu", "--quiet"])
    assert res["epochs"] == 3 and res["device"] == "cpu"
    assert np.isfinite(res["loss"]) and 0.0 <= res["test_acc"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["--model", "graphsage", "--layout", "hybrid", "--set", "hidden=64"],
    ["--model", "gcn", "--set", "aggregator=max"],
    ["--model", "graphsage", "--layout", "hybrid", "--set", "lr"],
])
def test_cli_set_takes_only_the_branch_keys(argv):
    with pytest.raises(SystemExit):
        main(argv + ["--device", "cpu", "--quiet", "--epochs", "1"])
