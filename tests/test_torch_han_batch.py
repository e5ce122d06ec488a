"""The dense GAT path and HAN's node-minibatch mode of the PyTorch port
against the JAX package on the CPU: ``DenseGATConv`` (a row without edges
included), ``DenseGAT`` and ``DenseHAN`` from the same flax parameters
(``params.from_flax``), the dense and the sparse GAT on the same weights,
``dense_metapath_stack`` and ``_batches``, and ``fit_han_minibatch``: the
same batches as JAX's from the same seed, its losses with dropout off
following JAX's from JAX's initial parameters, and learning above chance
with dropout on.

Tolerances, each against the largest entry of the output it holds, or for
a parameter's gradient the largest gradient entry of its module: float32
outputs ``F32_FWD`` = 2e-5, float32 gradients ``F32_GRAD`` = 1e-4 (float32
sums in other orders); bfloat16 ``BF16`` = 3e-2 (XLA and PyTorch round at
other places); the loop's losses ``LOSS_TOL`` = 1e-4 relative (float32 SGD
steps on gradients that differ by rounding). Batches and stacks: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.data import acm as jacm  # noqa: E402
from graphneuralnetwork_tpu.nn import (  # noqa: E402
    DenseGAT as JDenseGAT, DenseGATConv as JDenseGATConv,
    DenseHAN as JDenseHAN, GATConv as JGATConv)
from graphneuralnetwork_tpu.train import han_batch as jhb  # noqa: E402
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import acm as tacm  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import (  # noqa: E402
    DenseGAT as TDenseGAT, DenseGATConv as TDenseGATConv,
    DenseHAN as TDenseHAN, GATConv as TGATConv)
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import han_batch as thb  # noqa: E402
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as t_ce)
from test_torch_han import _close, _close_grads, _jax_params  # noqa: E402

F32_FWD, F32_GRAD, BF16, LOSS_TOL = 2e-5, 1e-4, 3e-2, 1e-4


def _adjacency(n=24, seed=0, empty_row=None):
    """A random receiver-row adjacency with self loops; ``empty_row``
    receives no edge at all."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.25).astype(np.float32)
    np.fill_diagonal(a, 1.0)
    if empty_row is not None:
        a[empty_row] = 0.0
    return a


def _both(jm, tm, graph_j, graph_t, x, labels, n_train):
    """Forward and the loss's gradients of a flax model and its port from
    the flax initialisation, dropout off."""
    params = jm.init(jax.random.PRNGKey(1), graph_j, jnp.asarray(x))[
        "params"]

    def jloss(p):
        out = jm.apply({"params": p}, graph_j, jnp.asarray(x))
        return j_ce(out[:n_train], jnp.asarray(labels[:n_train])), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tm.load_state_dict(_jax_params(params))
    tm.eval()
    xt = torch.from_numpy(x).requires_grad_()
    tout = tm(graph_t, xt)
    t_ce(tout[:n_train].float(),
         torch.from_numpy(labels[:n_train].astype(np.int64))).backward()
    return (np.asarray(jout, np.float32), _jax_params(jg),
            tout.detach().float().numpy(),
            {k: p.grad for k, p in tm.named_parameters()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("concat", [True, False])
def test_dense_gat_conv_matches_flax(concat, dtype):
    """Row 5 has no edge: both give it the uniform softmax over every
    node (the -9e15 mask), not a NaN."""
    bf16 = dtype == "bfloat16"
    a = _adjacency(empty_row=5)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 24)
    jm = JDenseGATConv(features=5, num_heads=3, concat_heads=concat,
                       dtype=jnp.bfloat16 if bf16 else None)
    tm = TDenseGATConv(6, 5, num_heads=3, concat_heads=concat,
                       dtype=torch.bfloat16 if bf16 else None)
    jo, jg, to, tg = _both(jm, tm, jnp.asarray(a), torch.from_numpy(a), x,
                           labels, 16)
    assert np.isfinite(to).all()
    fwd, grad = (F32_FWD, F32_GRAD) if not bf16 else (BF16, BF16)
    _close(to, jo, fwd, "out")
    _close_grads(tg, jg, grad)
    if concat and not bf16:   # the empty row: the mean of every node's h
        with torch.no_grad():
            h = torch.nn.functional.linear(torch.from_numpy(x),
                                           tm.linear.weight).view(24, 3, 5)
        torch.testing.assert_close(torch.from_numpy(to[5]).view(3, 5),
                                   h.mean(0), rtol=1e-5, atol=1e-6)


def test_dense_gat_conv_matches_sparse_gat():
    """The same weights through the dense and the sparse GAT (COO graph of
    the same edges) agree, as JAX's own test holds for its pair; the
    dense adjacency rebuilt from the graph is the one given."""
    a = _adjacency()
    s, r = np.nonzero(a.T)      # a[i, j] = edge j -> i: senders are j
    g = tgraph.build_graph(s.astype(np.int32), r.astype(np.int32), 24,
                           device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (24, 6)).astype(np.float32))
    sparse = TGATConv(6, 5, num_heads=3)
    sparse.reset_parameters(torch.Generator().manual_seed(1))
    dense = TDenseGATConv(6, 5, num_heads=3)
    dense.load_state_dict(sparse.state_dict())
    sparse.eval()
    dense.eval()
    with torch.no_grad():
        _close(dense(torch.from_numpy(a), x), sparse(g, x), F32_FWD,
               "dense vs sparse")
    torch.testing.assert_close(tgraph.dense_adj(g), torch.from_numpy(a))
    # JAX's pair on the same weights, as a cross-check of the convention
    jg = jgraph.build_graph(s.astype(np.int32), r.astype(np.int32), 24)
    params = JGATConv(features=5, num_heads=3).init(
        jax.random.PRNGKey(1), jg, jnp.asarray(x.numpy()))["params"]
    dense.load_state_dict(_jax_params(params))
    with torch.no_grad():
        got = dense(torch.from_numpy(a), x).numpy()
    _close(got, np.asarray(JDenseGATConv(features=5, num_heads=3).apply(
        {"params": params}, jnp.asarray(a), jnp.asarray(x.numpy()))),
        F32_FWD, "port dense vs JAX dense")


def test_dense_gat_matches_flax():
    a = _adjacency(n=30, seed=3, empty_row=2)
    rng = np.random.default_rng(4)
    x = rng.random((30, 10)).astype(np.float32)
    labels = rng.integers(0, 4, 30)
    jm = JDenseGAT(hidden=4, num_classes=4, num_heads=3)
    tm = TDenseGAT(10, hidden=4, num_classes=4, num_heads=3)
    assert sorted(k for k, _ in tm.named_parameters())[0] == \
        "attn1.attn_dst"
    jo, jg, to, tg = _both(jm, tm, jnp.asarray(a), torch.from_numpy(a), x,
                           labels, 20)
    _close(to, jo, F32_FWD, "logits")
    _close_grads(tg, jg, F32_GRAD)


@pytest.fixture(scope="module")
def acm_pair():
    return (jacm.load_acm_han(seed=0, n_papers=200),
            tacm.load_acm_han(seed=0, n_papers=200, device="cpu"))


def test_dense_metapath_stack_and_batches_equal_jax(acm_pair):
    jd, td = acm_pair
    np.testing.assert_array_equal(thb.dense_metapath_stack(td).numpy(),
                                  np.asarray(jhb.dense_metapath_stack(jd)))
    idx = np.asarray(jd.train_idx)
    for shuffle in (True, False):
        for bs in (16, 7, 1000):
            j = jhb._batches(idx, bs, np.random.default_rng(3), shuffle)
            t = thb._batches(idx, bs, np.random.default_rng(3), shuffle)
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_han_matches_flax(dtype, acm_pair):
    """DenseHAN on one gathered [2, B, B] sub-adjacency (B = 16)."""
    jd, td = acm_pair
    bf16 = dtype == "bfloat16"
    adj = np.asarray(jhb.dense_metapath_stack(jd))
    idx = np.asarray(jd.train_idx)[:16]
    sub = adj[:, idx][:, :, idx]
    x = np.asarray(jd.features)[idx]
    labels = np.asarray(jd.labels)[idx]
    jm = JDenseHAN(num_metapaths=2, num_classes=3,
                   dtype=jnp.bfloat16 if bf16 else None)
    tm = TDenseHAN(128, 2, 3, dtype=torch.bfloat16 if bf16 else None)
    jo, jg, to, tg = _both(jm, tm, jnp.asarray(sub), torch.from_numpy(sub),
                           x, labels, 16)
    fwd, grad = (F32_FWD, F32_GRAD) if not bf16 else (BF16, BF16)
    _close(to, jo, fwd, "logits")
    _close_grads(tg, jg, grad)


def _record_batches(module, monkeypatch):
    seen = []
    real = module._batches

    def recorded(idx, batch_size, rng, shuffle):
        out = real(idx, batch_size, rng, shuffle)
        seen.append((shuffle, np.asarray(out)))
        return out

    monkeypatch.setattr(module, "_batches", recorded)
    return seen


def test_fit_han_minibatch_follows_jax(acm_pair, monkeypatch):
    """Dropout off, from JAX's initial parameters: the same batches (one
    permutation an epoch, evaluation batches in order), losses and
    accuracies along the run, and the test accuracy."""
    jd, td = acm_pair
    kw = dict(batch_size=16, lr=0.05, epochs=3, dropout=0.0, eval_every=2,
              patience=20, seed=4)
    j_seen = _record_batches(jhb, monkeypatch)
    t_seen = _record_batches(thb, monkeypatch)
    init = []
    real_state = jhb.TrainState

    class Recording:
        @staticmethod
        def create(**kwargs):
            init.append(kwargs["params"])
            return real_state.create(**kwargs)

    monkeypatch.setattr(jhb, "TrainState", Recording)
    jres = jhb.fit_han_minibatch(jd, **kw)
    real_create = thb.create_train_state
    monkeypatch.setattr(
        thb, "create_train_state",
        lambda model, data, seed, opt: real_create(
            model, data, seed, opt, params=_jax_params(init[0])))
    tres = thb.fit_han_minibatch(td, **kw)
    assert len(t_seen) == len(j_seen) > 3
    for (ts, tb), (js, jb) in zip(t_seen, j_seen):
        assert ts == js
        np.testing.assert_array_equal(tb, jb)
    assert tres.epochs_run == jres.epochs_run == 3 * 3
    assert len(tres.history) == len(jres.history)
    for t, j in zip(tres.history, jres.history):
        assert t[0] == j[0]
        np.testing.assert_allclose(t[1:], j[1:], rtol=LOSS_TOL, atol=1e-6)
    assert tres.test_acc == pytest.approx(jres.test_acc, abs=1e-6)
    assert tres.best_val_loss == pytest.approx(jres.best_val_loss,
                                               rel=LOSS_TOL)


def test_fit_han_minibatch_keeps_best_params(acm_pair):
    """The best-val parameters are a copy, not the live tensors: after
    later steps they still give the recorded best val loss."""
    _, td = acm_pair
    res = thb.fit_han_minibatch(td, batch_size=16, epochs=6, eval_every=3,
                                seed=1)
    best = min(h[3] for h in res.history)
    assert res.best_val_loss == best
    assert all(np.isfinite(h[1]) for h in res.history)
    model = TDenseHAN(128, 2, 3)
    model.load_state_dict(res.best_params)
    model.eval()
    adj = thb.dense_metapath_stack(td)
    losses = []
    with torch.no_grad():
        for b in thb._batches(td.val_idx.numpy(), 16, None, shuffle=False):
            idx = torch.from_numpy(b)
            logits = model(adj[:, idx][:, :, idx], td.features[idx])
            losses.append(float(t_ce(logits, td.labels[idx])))
    assert float(np.mean(losses)) == pytest.approx(best, rel=1e-6)


@pytest.mark.heavy
def test_fit_han_minibatch_learns_with_dropout():
    """Dropout on (0.6): above chance (1/3) on the synthetic ACM."""
    data = tacm.load_acm_han(seed=0, n_papers=300, device="cpu")
    res = thb.fit_han_minibatch(data, batch_size=16, lr=0.2, epochs=40,
                                eval_every=10, patience=50, seed=0)
    assert np.isfinite(res.best_val_loss)
    assert res.test_acc > 0.45, res.test_acc


def test_cli_han_batch_on_cpu():
    from graphneuralnetwork_tpu_torch.cli import main
    res = main(["--model", "han_batch", "--epochs", "2", "--device", "cpu",
                "--quiet", "--set", "batch_size=16", "--set", "lr=0.1",
                "--set", "patience=5"])
    assert set(res) >= {"test_acc", "val_acc", "batches", "seconds",
                        "epochs", "loss", "epochs_per_s", "device"}
    assert res["epochs"] == 2 and res["batches"] == 2 * 8
    assert np.isfinite(res["loss"]) and 0.0 <= res["test_acc"] <= 1.0
