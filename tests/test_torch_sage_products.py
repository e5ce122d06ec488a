"""Full-batch GraphSAGE as OGB trains it on ogbn-products, on the COO
layout: the port against the benchmark's plain reference, and the COO mean
on K1's gathered form.

* The port's ``GraphSAGE`` (3 layers, dropout 0.5, the bias on the
  neighbour linear only, the COO mean on K1) against
  ``benchmark/reference/sage.py`` from the same weights, with the dropout
  drawn again from the port's generator by ``benchmark/masks.py``: logits,
  loss and every gradient, on a loop-carrying ``gcn_graph`` with padding
  edges, a node with no edge but its loop and a hub row. ``TOL``: each
  tensor against its own largest entry, 1e-5: float32 sums over a few
  hundred edges in another order (the port's last layer projects before it
  aggregates, the reference after) differ here by 2.7e-7 of it at most,
  and an aggregation rounded to bfloat16 (up to 3.9e-3) fails it, which a
  case checks.
* ``SAGEConv``'s COO mean and sum against the gathered copy they replace
  (``x[senders]`` with ``segment_mean``, or weighted and summed), forward
  and gradient; and a dispatch mode that sees no tensor of E rows in the
  COO mean's forward and backward outside K1's own call.
* The hybrid mean's counts, summed once per graph and dtype, and the one
  rule by which a narrowing ``mean`` aggregates the projection.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.masks import MaskReplay  # noqa: E402
from benchmark.reference import gnn  # noqa: E402
from graphneuralnetwork_tpu_torch.core.bcsr import build_hybrid  # noqa: E402
from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    build_graph, gcn_graph, symmetrize)
from graphneuralnetwork_tpu_torch.nn import GraphSAGE  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import conv  # noqa: E402
from graphneuralnetwork_tpu_torch.nn.conv import SAGEConv  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import (  # noqa: E402
    aggregate, bcsr_spmm, segment_mean)
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy)
from graphneuralnetwork_tpu_torch.utils.profiling import (  # noqa: E402
    host_spans, reset_spans)

N, FEATS, HIDDEN, CLASSES = 400, 12, 32, 5
HUB, LONELY = 5, N - 1
TOL = 1e-5
CFG = {"model": "sage", "in_features": FEATS, "hidden": HIDDEN,
       "num_layers": 3, "num_classes": CLASSES, "aggregator": "mean",
       "dropout": 0.5}


def _pairs(seed=0):
    """Undirected pairs: ~6 a node at random, node ``HUB`` joined to 150
    others (a row above ``Graph.long_edges``), node ``LONELY`` in none."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, N - 1, 1200)
    r = rng.integers(0, N - 1, 1200)
    hub = rng.choice(np.setdiff1d(np.arange(N - 1), [HUB]), 150,
                     replace=False)
    s = np.concatenate([s, np.full(150, HUB)])
    r = np.concatenate([r, hub])
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32)


@pytest.fixture(scope="module")
def products_like():
    s, r = _pairs()
    graph = gcn_graph(s, r, N, device="cpu")
    assert graph.n_edge_pad > graph.n_edges         # padding edges
    assert HUB in graph.long_rows.tolist()
    deg = np.diff(graph.row_ptr.numpy())
    assert deg[LONELY] == 1                        # its loop alone
    edges = gnn.canonical_edges(s, r, N, "cpu")
    assert edges.recv.shape[0] == graph.n_edges
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(N, FEATS)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, N))
    train = torch.arange(0, N, 3)
    return graph, edges, x, labels, train


def _close(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def _port_and_reference(products_like, monkeypatch):
    """Logits, loss and gradients by name of the port's model and of the
    plain reference from the same weights and dropout draws."""
    graph, edges, x, labels, train = products_like
    torch.set_num_threads(1)
    ref = gnn.model(CFG)
    monkeypatch.setattr(ref, "EDGE_BLOCK", 256)   # several blocks a mean
    params = gnn.initial_params(CFG, 7, "cpu")
    gen = torch.Generator().manual_seed(3)
    for k in params:
        if k.endswith("bias"):
            params[k] = torch.randn(params[k].shape, generator=gen) * 0.1
    model = spec.part("models", "sage").make_model(CFG)
    model.load_state_dict(params)
    model.train()
    state = gen.get_state()
    logits = model(graph, x, generator=gen)
    loss = masked_softmax_cross_entropy(logits[train], labels[train])
    loss.backward()
    port = (logits.detach(), loss.item(),
            {k: p.grad for k, p in model.named_parameters()})

    masks = MaskReplay(CFG, graph, None, edges.keys, "cpu").step(state,
                                                                 "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    r_logits = ref.forward(CFG, leaves, x, edges, masks)
    r_loss = gnn.loss_fn(r_logits, labels, train)
    grads = torch.autograd.grad(r_loss, list(leaves.values()))
    return port, (r_logits.detach(), r_loss.item(), dict(zip(leaves, grads)))


def _gaps(port, reference) -> dict:
    (logits, loss, grads), (r_logits, r_loss, r_grads) = port, reference
    assert set(grads) == set(r_grads)
    gaps = {k: _close(grads[k], r_grads[k]) for k in r_grads}
    gaps["logits"] = _close(logits, r_logits)
    gaps["loss"] = abs(loss - r_loss) / abs(r_loss)
    return gaps


def test_graphsage_matches_the_plain_reference(products_like, monkeypatch):
    port, reference = _port_and_reference(products_like, monkeypatch)
    gaps = _gaps(port, reference)
    assert max(gaps.values()) < TOL, gaps
    # every layer carries PyG's bias on its neighbour linear alone
    assert sorted(port[2]) == sorted(
        f"{layer}.{part}" for layer in ("sage0", "sage1", "sage_out")
        for part in ("neighbor.weight", "neighbor.bias", "self.weight"))


def test_a_bfloat16_aggregation_fails_the_comparison(products_like,
                                                     monkeypatch):
    """The tolerance is tight enough to see the mean rounded to bfloat16
    (its inputs and its result), the rest float32."""
    real = conv.aggregate_mean
    monkeypatch.setattr(conv, "aggregate_mean", lambda g, x: real(
        g, x.bfloat16()).float())
    gaps = _gaps(*_port_and_reference(products_like, monkeypatch))
    assert max(gaps.values()) > 10 * TOL, gaps


def _coo_graphs():
    """The loop-carrying ``gcn_graph`` (sym-normalised weights) and the same
    pairs without loops, unit weights: node ``LONELY`` has no edge."""
    s, r = _pairs()
    return {"gcn": gcn_graph(s, r, N, device="cpu"),
            "bare": build_graph(*symmetrize(s, r), N, device="cpu")}


@pytest.mark.parametrize("graph_name", ["gcn", "bare"])
@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_coo_mean_and_sum_match_the_gathered_copy(aggregator, graph_name):
    graph = _coo_graphs()[graph_name]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(N, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, 24)).astype(np.float32))
    layer = SAGEConv(24, 8, aggregator=aggregator)
    outs = []
    for new in (True, False):
        xi = x.clone().requires_grad_()
        if new:
            out = layer._aggregate(graph, xi)
        else:
            msgs = xi[graph.senders]
            if aggregator == "mean":
                out = segment_mean(msgs, graph.receivers, graph.n_nodes,
                                   mask=graph.edge_mask)
            else:
                out = aggregate.aggregate_edges(
                    graph, msgs * graph.edge_weight[:, None])
        out.backward(g)
        outs.append((out.detach(), xi.grad))
    (out, dx), (want, want_dx) = outs
    torch.testing.assert_close(out, want, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(dx, want_dx, rtol=2e-6, atol=2e-6)
    if graph_name == "bare" and aggregator == "mean":
        assert not out[LONELY].any()


class _EdgeRows(TorchDispatchMode):
    """Records the shape of every tensor an operation returns with as many
    rows as ``rows`` names, except while ``aggregate.segment_sum`` (K1,
    one kernel on the card; its plain version here gathers) runs."""

    def __init__(self, rows):
        super().__init__()
        self.rows, self.inside, self.seen = set(rows), False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = out if isinstance(out, (tuple, list)) else [out]
        for t in flat:
            if (not self.inside and isinstance(t, torch.Tensor)
                    and t.ndim and t.shape[0] in self.rows):
                self.seen.append((str(func), tuple(t.shape)))
        return out


def test_coo_mean_forms_no_tensor_of_edge_rows(products_like, monkeypatch):
    graph, _, x, labels, train = products_like
    graph.mean_weights                  # the per-graph cache, [E_pad]
    mode = _EdgeRows({graph.n_edges, graph.n_edge_pad})
    real = aggregate.segment_sum

    def k1(*args, **kwargs):
        mode.inside = True
        try:
            return real(*args, **kwargs)
        finally:
            mode.inside = False

    monkeypatch.setattr(aggregate, "segment_sum", k1)
    model = spec.part("models", "sage").make_model(CFG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with mode:
        logits = model(graph, x, generator=gen)
        masked_softmax_cross_entropy(logits[train], labels[train]).backward()
        assert mode.seen == []
        # the copy the COO mean replaced would have been seen
        segment_mean(x[graph.senders], graph.receivers, N,
                     mask=graph.edge_mask)
    assert mode.seen


def test_coo_mean_weights_are_built_once_and_count_as_k1_mean(monkeypatch):
    graph = _coo_graphs()["gcn"]
    calls = []
    real = aggregate.segment_sum

    def k1(*args, **kwargs):
        calls.append(kwargs.get("tally"))
        return real(*args, **kwargs)

    monkeypatch.setattr(aggregate, "segment_sum", k1)
    reset_spans()
    x = torch.randn(N, 6, requires_grad=True)
    aggregate.aggregate_mean(graph, x).sum().backward()
    aggregate.aggregate_mean(graph, x.detach())
    assert host_spans()["graph.mean_weights"][1] == 1
    # forward, backward over the transpose, forward: each K1_mean's
    assert calls == [counters.COUNTERS["K1_mean"]] * 3
    deg = np.diff(graph.row_ptr.numpy())
    w = graph.mean_weights.numpy()
    assert np.array_equal(w[:graph.n_edges],
                          (1.0 / deg.astype(np.float32))[
                              graph.receivers[:graph.n_edges].numpy()])
    assert not w[graph.n_edges:].any()


def test_hybrid_mean_counts_once_per_graph_and_dtype(monkeypatch):
    """The hybrid mean divides by ``spmm(graph, 1)``, now summed at the
    first mean over the graph in a dtype and kept: a 2-layer model's first
    forward launches K3 and K1 three times each (the counts, then each
    layer's sum), every later one twice; the result is unchanged."""
    s, r = symmetrize(*_pairs())
    graph = build_hybrid(s, r, N, min_edges_per_tile=40, symmetric=True,
                         device="cpu")
    assert graph.bcsr.n_edges > 0 and graph.rem.n_edges > 0
    launches = {"K1": 0, "K3": 0}

    def counting(module, name, kernel):
        real = getattr(module, name)

        def call(*args, **kwargs):
            launches[kernel] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, call)

    counting(aggregate, "segment_sum", "K1")
    counting(bcsr_spmm, "_bcsr_spmm_kernel", "K3")
    model = GraphSAGE(FEATS, hidden_dims=(16,), num_classes=CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(N, FEATS)
    with torch.no_grad():
        first = model(graph, x)
        assert launches == {"K1": 3, "K3": 3}
        second = model(graph, x)
        assert launches == {"K1": 5, "K3": 5}
        counts = graph.mean_counts[torch.float32]
        ones = torch.ones(N, 1)
        assert torch.equal(counts, torch.clamp_min(conv.spmm(graph, ones),
                                                   1.0))
        h = model.sage0(graph, x)
        want = model.sage0.self(x) + model.sage0.neighbor(
            conv.spmm(graph, x) / counts)
    assert torch.equal(first, second)
    torch.testing.assert_close(h, torch.relu(want), rtol=0, atol=0)
    assert list(graph.mean_counts) == [torch.float32]


@pytest.mark.parametrize("layout", ["coo", "hybrid"])
@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
def test_a_narrowing_mean_aggregates_the_projection(aggregator, layout):
    """Into fewer columns ``mean`` aggregates ``neighbor``'s projection on
    every layout (it is linear: the same result over fewer columns);
    ``sum`` and ``max`` aggregate ``x``, as every aggregator does when
    widening."""
    s, r = symmetrize(*_pairs())
    graph = (build_graph(s, r, N, device="cpu") if layout == "coo" else
             build_hybrid(s, r, N, min_edges_per_tile=40, symmetric=True,
                          device="cpu"))
    x = torch.randn(N, 24, generator=torch.Generator().manual_seed(5))
    for out_features in (8, 40):
        layer = SAGEConv(24, out_features, aggregator=aggregator,
                         use_bias=True)
        layer.reset_parameters(torch.Generator().manual_seed(6))
        with torch.no_grad():
            layer.neighbor.bias.normal_()
            widths = []
            real = layer._aggregate

            def spy(graph, h):
                widths.append(h.shape[1])
                return real(graph, h)

            layer._aggregate = spy
            got = layer._neighbor(graph, x)
            want = layer.neighbor(real(graph, x))
        narrow = out_features < 24 and aggregator == "mean"
        assert widths == [out_features if narrow else 24]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sage_bias_placement_and_graphsage_defaults():
    pyg = SAGEConv(8, 4, use_bias="neighbor")
    assert pyg.neighbor.bias is not None and pyg.self.bias is None
    both = SAGEConv(8, 4, use_bias=True)
    assert both.neighbor.bias is not None and both.self.bias is not None
    with pytest.raises(ValueError, match="use_bias"):
        SAGEConv(8, 4, use_bias="self")
    plain = GraphSAGE(8, hidden_dims=(4, 4), num_classes=3)
    assert plain.dropout == 0.0
    assert not any(k.endswith("bias") for k, _ in plain.named_parameters())
    ogb = GraphSAGE(8, hidden_dims=(4, 4), num_classes=3, dropout=0.5,
                    neighbor_bias=True)
    assert sorted(k for k, _ in ogb.named_parameters()
                  if k.endswith("bias")) == [
        "sage0.neighbor.bias", "sage1.neighbor.bias", "sage_out.neighbor.bias"]


def test_reference_mean_is_the_plain_aggregate(products_like, monkeypatch):
    """``reference/sage.py``'s blocked mean and its transposed backward
    against ``gnn.aggregate`` (one gather of every edge) under autograd."""
    _, edges, x, _, _ = products_like
    ref = gnn.model(CFG)
    monkeypatch.setattr(ref, "EDGE_BLOCK", 300)
    g = torch.randn(N, FEATS, generator=torch.Generator().manual_seed(2))
    deg = torch.bincount(edges.recv, minlength=N).float()
    outs = []
    for blocked in (True, False):
        xi = x.clone().requires_grad_()
        out = (ref.mean(edges, xi) if blocked else
               gnn.aggregate(edges, deg.reciprocal()[edges.recv], xi))
        out.backward(g)
        outs.append((out.detach(), xi.grad))
    (out, dx), (want, want_dx) = outs
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, want_dx, rtol=1e-6, atol=1e-6)


def test_the_model_files_canonical_edges_are_the_references():
    """``benchmark/models/sage.py`` hands the harness its own
    ``canonical_edges``: the keys of ``reference/gnn.py``'s
    ``np.unique``, by a sort, over pairs with twins, both directions and
    loops."""
    model = spec.part("models", "sage")
    assert gnn.canonical_edges is model.canonical_edges
    s, r = _pairs(seed=2)
    s = np.concatenate([s, s[:40], r[40:80], [3, 9]]).astype(np.int32)
    r = np.concatenate([r, r[:40], s[40:80], [3, 9]]).astype(np.int32)
    both_s = np.concatenate([s, r, np.arange(N)]).astype(np.int64)
    both_r = np.concatenate([r, s, np.arange(N)]).astype(np.int64)
    want = np.unique(both_r * N + both_s)
    edges = model.canonical_edges(s, r, N, "cpu")
    assert edges.n == N
    assert edges.recv.dtype == edges.send.dtype == torch.int64
    np.testing.assert_array_equal(edges.keys.numpy(), want)
