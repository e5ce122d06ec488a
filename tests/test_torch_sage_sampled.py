"""The sampled GraphSAGE pipeline of the PyTorch port (``nn/sage.py``,
``train/sage_loop.py``, ``SAGEConv``'s concat, the binary-logit metrics and
the CLI's sampled branches) against the JAX package on the CPU.

The same weights (``params.from_flax``) and the same hop features: logits
and every parameter gradient within ``F32_TOL`` (float32 sums in other
orders, ~1e-7 measured). The loops draw their hops from the same numpy
seed in both packages, on both packages' numpy samplers
(``use_native=False``) and, at the defaults, on their C++ engines; they
start from the same parameters (JAX's, handed to the port by replacing its
``_init_params``) and must draw identical hops batch for batch; their
losses then agree within ``LOSS_TOL`` (AdamW steps on gradients that
differ by float32 rounding). Each package gets its own data object: JAX's
supervised loop shuffles ``data.train_idx`` in place.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.data import pubmed as jpubmed  # noqa: E402
from graphneuralnetwork_tpu.nn.conv import SAGEConv as JSAGEConv  # noqa: E402
from graphneuralnetwork_tpu.nn.sage import (  # noqa: E402
    SageLayer as JSageLayer, SampledGraphSAGE as JSampled)
from graphneuralnetwork_tpu.sampling import neighbor as j_neighbor  # noqa: E402
from graphneuralnetwork_tpu.train import metrics as jmetrics  # noqa: E402
from graphneuralnetwork_tpu.train import sage_loop as j_loop  # noqa: E402
from graphneuralnetwork_tpu_torch import cli  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import pubmed as tpubmed  # noqa: E402
from graphneuralnetwork_tpu_torch.nn.conv import SAGEConv as TSAGEConv  # noqa: E402
from graphneuralnetwork_tpu_torch.nn.sage import (  # noqa: E402
    SageLayer as TSageLayer, SampledGraphSAGE as TSampled)
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import (  # noqa: E402
    csr_from_edges, multihop_sampling)
from graphneuralnetwork_tpu_torch.sampling import neighbor as t_neighbor  # noqa: E402
from graphneuralnetwork_tpu_torch.train import metrics as tmetrics  # noqa: E402
from graphneuralnetwork_tpu_torch.train import sage_loop as t_loop  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
#: History losses of the two loops: the same batches and initial weights,
#: AdamW on gradients ~1e-7 apart, over 2 epochs (6 steps) supervised and
#: 1 epoch (9 steps) unsupervised.
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
FANOUTS, DIMS, B, F = (3, 2), (16, 3), 4, 10


def _grads_of(tm):
    return {k: p.grad.numpy() for k, p in tm.named_parameters()}


def _jgrads(grads):
    return {k: v.numpy() for k, v in
            from_flax(jax.tree.map(np.asarray, grads)).items()}


def _compare(jlogits, jgrads, tlogits, tgrads):
    np.testing.assert_allclose(tlogits, np.asarray(jlogits), **F32_TOL)
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name, **F32_TOL)


def _hop_features(gathered: bool):
    """[B, F], [B·3, F], [B·6, F]: random rows, or rows of a small feature
    table gathered at sampled hops (repeated neighbours make ties for the
    max)."""
    rng = np.random.default_rng(1)
    if not gathered:
        return [rng.normal(size=(B * n, F)).astype(np.float32)
                for n in (1, 3, 6)]
    table = rng.normal(size=(30, F)).astype(np.float32)
    s = rng.integers(0, 30, 90)
    r = rng.integers(0, 30, 90)
    indptr, indices, _ = csr_from_edges(s, r, 30)
    hops = multihop_sampling(np.arange(B), FANOUTS, indptr, indices,
                             np.random.default_rng(2))
    return [table[h] for h in hops]


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_sampled_graphsage_matches_flax(aggregator, gathered):
    feats = _hop_features(gathered)
    labels = np.random.default_rng(3).integers(0, DIMS[-1], B)
    jm = JSampled(dims=DIMS, fanouts=FANOUTS, aggregator=aggregator)
    params = jm.init(jax.random.PRNGKey(0),
                     [jnp.asarray(h) for h in feats])["params"]

    def jloss(p):
        logits = jm.apply({"params": p}, [jnp.asarray(h) for h in feats])
        return jmetrics.masked_softmax_cross_entropy(
            logits, jnp.asarray(labels)), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = TSampled(F, DIMS, FANOUTS, aggregator=aggregator)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tlogits = tm([torch.from_numpy(h) for h in feats])
    tmetrics.masked_softmax_cross_entropy(
        tlogits, torch.from_numpy(labels)).backward()
    assert sorted(_grads_of(tm)) == [
        "layer0.neighbor.weight", "layer0.self.weight",
        "layer1.neighbor.weight", "layer1.self.weight"]
    _compare(jlogits, _jgrads(jgrads), tlogits.detach().numpy(),
             _grads_of(tm))


@pytest.mark.parametrize("combine", ["sum", "concat"])
@pytest.mark.parametrize("activation", ["relu", None])
def test_sage_layer_matches_flax(combine, activation):
    self_f, neigh_f = _hop_features(False)[:2]
    jl = JSageLayer(features=5, aggregator="mean", combine=combine,
                    activation=activation)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(self_f),
                     jnp.asarray(neigh_f), 3)["params"]

    def jsum(p):
        out = jl.apply({"params": p}, jnp.asarray(self_f),
                       jnp.asarray(neigh_f), 3)
        return jnp.sum(out * jnp.arange(out.size).reshape(out.shape)), out

    (_, jout), jgrads = jax.value_and_grad(jsum, has_aux=True)(params)
    tl = TSageLayer(F, 5, aggregator="mean", combine=combine,
                    activation=activation)
    tl.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tout = tl(torch.from_numpy(self_f), torch.from_numpy(neigh_f), 3)
    assert tout.shape == ((B, 10) if combine == "concat" else (B, 5))
    torch.sum(tout * torch.arange(tout.numel()).reshape(tout.shape)
              ).backward()
    _compare(jout, _jgrads(jgrads), tout.detach().numpy(), _grads_of(tl))


def test_sampled_graphsage_widths():
    """Layer 0 takes F, a later layer the width before it; a fanout per
    layer."""
    tm = TSampled(F, (6, 3), FANOUTS)
    assert tm.layer0.self.in_features == F
    assert tm.layer1.self.in_features == 6
    out = tm([torch.from_numpy(h) for h in _hop_features(False)])
    assert out.shape == (B, 3)
    with pytest.raises(ValueError, match="fanouts"):
        TSampled(F, (6, 3), (3,))
    with pytest.raises(ValueError, match="hops"):
        tm([torch.from_numpy(h) for h in _hop_features(False)[:2]])


def _conv_graphs():
    """``tests/test_torch_sage.py``'s clustered graph: 640 nodes in blocks
    of 128, 15 % of the edges between blocks."""
    rng = np.random.default_rng(0)
    n, comm, e = 640, 128, 6000
    s = rng.integers(0, n, e)
    r = np.where(rng.random(e) >= 0.15, (s // comm) * comm
                 + rng.integers(0, comm, e), rng.integers(0, n, e))
    keep = s != r
    s, r = jgraph.symmetrize(s[keep].astype(np.int32),
                             r[keep].astype(np.int32))
    x = rng.normal(size=(n, 12)).astype(np.float32)
    return s, r, n, x


@pytest.mark.parametrize("layout", ["coo", "hybrid"])
@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_sageconv_concat_matches_flax(layout, aggregator):
    s, r, n, x = _conv_graphs()
    if layout == "coo":
        jg = jgraph.build_graph(s, r, n)
        tg = tgraph.build_graph(s, r, n, device="cpu")
    else:
        jg = jbcsr.build_hybrid(s, r, n, min_edges_per_tile=192,
                                symmetric=True)
        tg = tbcsr.build_hybrid(s, r, n, min_edges_per_tile=192,
                                symmetric=True, device="cpu")
        assert tg.tiled_fraction > 0.5 and tg.rem.n_edges > 0
    jc = JSAGEConv(features=6, aggregator=aggregator, combine="concat",
                   activation=jax.nn.relu)
    params = jc.init(jax.random.PRNGKey(2), jg, jnp.asarray(x))["params"]
    w = np.random.default_rng(5).normal(size=(n, 12)).astype(np.float32)

    def jsum(p):
        out = jc.apply({"params": p}, jg, jnp.asarray(x))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgrads = jax.value_and_grad(jsum, has_aux=True)(params)
    tc = TSAGEConv(12, 6, aggregator=aggregator, combine="concat",
                   activation=torch.relu)
    tc.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tout = tc(tg, torch.from_numpy(x))
    assert tout.shape == (n, 12)
    torch.sum(tout * torch.from_numpy(w)).backward()
    _compare(jout, _jgrads(jgrads), tout.detach().numpy(), _grads_of(tc))


def test_sageconv_rejects_an_unknown_combine():
    with pytest.raises(ValueError, match="combine"):
        TSAGEConv(4, 4, combine="max")


def test_binary_metrics_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(16, 6)) * 4).astype(np.float32)
    logits[0, :3] = [0.0, 60.0, -60.0]
    labels = (rng.random((16, 6)) < 0.3).astype(np.float32)
    mask = (rng.random((16, 6)) < 0.7).astype(np.float32)
    tl, ty, tmk = (torch.from_numpy(a) for a in (logits, labels, mask))
    np.testing.assert_allclose(
        tmetrics.sigmoid_binary_cross_entropy(tl, ty).numpy(),
        np.asarray(optax.sigmoid_binary_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6,
        atol=1e-7)
    for m in (None, mask):
        want = jmetrics.binary_accuracy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = tmetrics.binary_accuracy(tl, ty, None if m is None else tmk)
        assert float(got) == pytest.approx(float(want), abs=1e-7)


def test_sage_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(j_loop.SageConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(t_loop.SageConfig)]
    assert tf == jf
    assert cli._SAGE_FIELDS == tuple(name for name, _ in tf)


def _recorder(module, store, monkeypatch):
    """Replace ``module.multihop_sampling`` by a wrapper that keeps a copy
    of every batch's hops."""
    orig = module.multihop_sampling

    def record(nodes, fanouts, indptr, indices, rng):
        hops = orig(nodes, fanouts, indptr, indices, rng)
        store.append([np.array(h) for h in hops])
        return hops

    monkeypatch.setattr(module, "multihop_sampling", record)


@pytest.fixture
def numpy_samplers(monkeypatch):
    """Both packages' samplers on their numpy paths (their defaults draw
    on the C++ engines)."""
    for neighbor, loop in ((j_neighbor, j_loop), (t_neighbor, t_loop)):
        monkeypatch.setattr(neighbor, "sample_neighbors", functools.partial(
            neighbor.sample_neighbors, use_native=False))
        monkeypatch.setattr(loop, "uniform_walks", functools.partial(
            loop.uniform_walks, use_native=False))


def _jax_init_params(monkeypatch, dims, cfg, in_features):
    """JAX's initial parameters (flax's init depends on the input shapes
    only), handed to the port in place of its own draw."""
    n_hops = np.cumprod((1,) + tuple(cfg.fanouts))
    shapes = [jnp.zeros((cfg.batch_size * int(k), in_features))
              for k in n_hops]
    params = JSampled(dims=dims, fanouts=tuple(cfg.fanouts),
                      aggregator=cfg.aggregator).init(
        jax.random.PRNGKey(cfg.seed), shapes)["params"]
    state = from_flax(jax.tree.map(np.asarray, params))
    monkeypatch.setattr(t_loop, "_init_params",
                        lambda model, seed: model.load_state_dict(state))


def _cfg(**kw):
    base = dict(fanouts=(4, 3), hidden=16, batch_size=32, lr=1e-2)
    base.update(kw)
    return j_loop.SageConfig(**base), t_loop.SageConfig(**base)


def _supervised_matches_jax(monkeypatch, aggregator, optimizer):
    jcfg, tcfg = _cfg(epochs=2, batch_size=16, aggregator=aggregator,
                      optimizer=optimizer)
    jdata = jpubmed.load_pubmed(n_nodes=480, n_feats=32, seed=1)
    tdata = tpubmed.load_pubmed(n_nodes=480, n_feats=32, seed=1)
    train0 = np.array(tdata.train_idx)
    jhops, thops = [], []
    _recorder(j_loop, jhops, monkeypatch)
    _recorder(t_loop, thops, monkeypatch)
    _jax_init_params(monkeypatch, (16, jdata.num_classes), jcfg, 32)
    _, jhist, jtest = j_loop.train_sage_supervised(jdata, jcfg)
    _, thist, ttest = t_loop.train_sage_supervised(tdata, tcfg,
                                                   device="cpu")
    # the init draw, 2 x (3 train + 9 val batches), 18 test batches
    assert len(thops) == len(jhops) == 1 + 2 * (3 + 9) + 18
    for tb, jb in zip(thops, jhops):
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tdata.train_idx, train0)   # not shuffled
    assert [h[0] for h in thist] == [h[0] for h in jhist] == [1, 2]
    np.testing.assert_allclose([h[1] for h in thist],
                               [h[1] for h in jhist], **LOSS_TOL)
    # the accuracies of the same batches: one node may flip at most
    assert [h[2] for h in thist] == pytest.approx([h[2] for h in jhist],
                                                  abs=1.01 / 144)
    assert ttest == pytest.approx(jtest, abs=1.01 / 288)
    return thops


@pytest.mark.parametrize("aggregator,optimizer", [("mean", "adamw"),
                                                   ("max", "sgd")])
def test_supervised_loop_matches_jax(aggregator, optimizer, monkeypatch,
                                     numpy_samplers):
    _supervised_matches_jax(monkeypatch, aggregator, optimizer)


def test_supervised_loop_on_the_engines_matches_jax(monkeypatch):
    """At the defaults both loops draw on their C++ engines: the same hops
    as each other, other hops than the numpy samplers'."""
    thops = _supervised_matches_jax(monkeypatch, "mean", "adamw")
    data = tpubmed.load_pubmed(n_nodes=480, n_feats=32, seed=1)
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers, 480)
    numpy_hop = t_neighbor.sample_neighbors(
        thops[0][0], 4, indptr, indices,
        np.random.default_rng(t_loop.SageConfig().seed), use_native=False)
    assert not np.array_equal(numpy_hop, thops[0][1])


def _unsupervised_matches_jax(monkeypatch):
    jcfg, tcfg = _cfg(epochs=1)
    jdata = jpubmed.load_pubmed(n_nodes=300, n_feats=32, seed=2)
    tdata = tpubmed.load_pubmed(n_nodes=300, n_feats=32, seed=2)
    jhops, thops = [], []
    _recorder(j_loop, jhops, monkeypatch)
    _recorder(t_loop, thops, monkeypatch)
    _jax_init_params(monkeypatch, (16, 16), jcfg, 32)
    _, jhist = j_loop.train_sage_unsupervised(jdata, jcfg)
    _, thist = t_loop.train_sage_unsupervised(tdata, tcfg, device="cpu")
    # init draw, then 9 batches x (batch, contexts, negatives)
    assert len(thops) == len(jhops) == 1 + 9 * 3
    for tb, jb in zip(thops, jhops):
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose([h[1] for h in thist],
                               [h[1] for h in jhist], **LOSS_TOL)
    np.testing.assert_allclose([h[2] for h in thist],
                               [h[2] for h in jhist], atol=1e-6)


def test_unsupervised_loop_matches_jax(monkeypatch, numpy_samplers):
    _unsupervised_matches_jax(monkeypatch)


def test_unsupervised_loop_on_the_engines_matches_jax(monkeypatch):
    """The walks and hops of the unsupervised loop on both C++ engines."""
    _unsupervised_matches_jax(monkeypatch)


def test_sage_embed_all_matches_jax(numpy_samplers):
    """The same parameters embed every node (the last batch wrapped) from
    the same hops: JAX's embeddings within ``F32_TOL``."""
    jcfg, tcfg = _cfg(fanouts=(3, 2), hidden=8)
    jdata = jpubmed.load_pubmed(n_nodes=100, n_feats=16, seed=3)
    tdata = tpubmed.load_pubmed(n_nodes=100, n_feats=16, seed=3)
    shapes = [jnp.zeros((32 * k, 16)) for k in (1, 3, 6)]
    params = JSampled(dims=(8, 8), fanouts=(3, 2)).init(
        jax.random.PRNGKey(4), shapes)["params"]
    want = j_loop.sage_embed_all(params, jdata, jcfg)
    got = t_loop.sage_embed_all(
        from_flax(jax.tree.map(np.asarray, params)), tdata, tcfg)
    assert got.shape == want.shape == (100, 8)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_sage_embed_all():
    data = tpubmed.load_pubmed(n_nodes=100, n_feats=16, seed=3)
    cfg = t_loop.SageConfig(fanouts=(3, 2), hidden=8, batch_size=32,
                            epochs=1)
    params, _ = t_loop.train_sage_unsupervised(data, cfg, device="cpu")
    emb = t_loop.sage_embed_all(params, data, cfg)
    assert emb.shape == (100, 8) and np.isfinite(emb).all()


def test_device_sampling_loop_on_the_cpu():
    data = tpubmed.load_pubmed(n_nodes=300, n_feats=32, seed=0)
    cfg = t_loop.SageConfig(fanouts=(4, 3), hidden=16, batch_size=32,
                            epochs=3, device_sampling=True,
                            max_table_degree=6)
    params, hist, test_acc = t_loop.train_sage_supervised(data, cfg,
                                                          device="cpu")
    assert [h[0] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h[1]) for h in hist) and 0 <= test_acc <= 1
    assert sorted(params) == ["layer0.neighbor.weight", "layer0.self.weight",
                              "layer1.neighbor.weight", "layer1.self.weight"]


def _cli(argv):
    return cli.main(argv + ["--device", "cpu", "--quiet"])


def test_cli_graphsage_reaches_the_repro_criterion():
    """``--model graphsage`` at its defaults (Pubmed synthetic, 5 epochs,
    fanouts 10,10, AdamW): REPRO.md's test_acc >= 0.80."""
    res = _cli(["--model", "graphsage"])
    assert res["test_acc"] >= 0.80, res
    assert res["epochs"] == 5 and res["history_tail"][0] == 5
    assert res["device"] == "cpu" and res["epochs_per_s"] > 0


def test_cli_graphsage_unsup_reaches_the_repro_criterion():
    """``--model graphsage_unsup`` at its defaults on the full Pubmed
    synthetic: REPRO.md's binary_acc >= 0.75."""
    res = _cli(["--model", "graphsage_unsup"])
    assert res["binary_acc"] >= 0.75, res
    assert np.isfinite(res["final_loss"]) and res["initial_loss"] > 0


def test_cli_set_fanouts(monkeypatch):
    seen = []
    orig = t_loop.multihop_sampling

    def record(nodes, fanouts, *args):
        seen.append(tuple(fanouts))
        return orig(nodes, fanouts, *args)

    monkeypatch.setattr(t_loop, "multihop_sampling", record)
    res = _cli(["--model", "graphsage", "--epochs", "1",
                "--set", "fanouts=5,5"])
    assert set(seen) == {(5, 5)} and 0.0 <= res["test_acc"] <= 1.0


def test_cli_set_device_sampling():
    res = _cli(["--model", "graphsage", "--set", "device_sampling=true",
                "--set", "aggregator=max"])
    assert res["test_acc"] >= 0.80, res


def test_cli_sgd_sets_the_reference_recipe(monkeypatch):
    seen = {}

    def fake(data, cfg, verbose, device):
        seen.update(dataclasses.asdict(cfg))
        return {}, [(1, 0.5, 0.5)], 0.5

    monkeypatch.setattr(t_loop, "train_sage_supervised", fake)
    _cli(["--model", "graphsage", "--optimizer", "sgd", "--set", "lr=0.05"])
    assert (seen["optimizer"], seen["lr"], seen["weight_decay"],
            seen["epochs"]) == ("sgd", 0.05, 1e-4, 5)


@pytest.mark.parametrize("argv", [
    ["--model", "graphsage", "--set", "bogus=1"],
    ["--model", "graphsage_unsup", "--set", "dropout=0.5"],
    ["--model", "graphsage", "--layout", "hybrid", "--set", "fanouts=5,5"],
])
def test_cli_unknown_set_key_exits(argv):
    with pytest.raises(SystemExit):
        _cli(argv)
