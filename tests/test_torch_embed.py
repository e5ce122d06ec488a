"""The walk embedders' models and loops (``nn/embed.py``,
``train/embed_loop.py``, ``models/embedding.py``) against the JAX package
on the CPU.

The models' forwards and gradients take the same parameters (flax's,
through ``params.from_flax``) and the same inputs: within ``SCALE_TOL``
of each output's largest entry (float32 sums in other orders). The host
loops start from JAX's initial parameters (the port's ``_init_params``
replaced) and draw their walks, corpus and batches from the same numpy
seed, on both packages' numpy paths (``use_native=False`` for DeepWalk's
uniform walks, Struc2Vec's distances in numpy) and, at the defaults, on
their C++ engines; their loss
histories must agree within ``LOSS_TOL`` and their final tables within
``TABLE_TOL`` over 2 epochs (Adam steps on gradients that differ by
float32 rounding). The device loop (``CapturedEpochs``) runs on the CPU
device eagerly, checked for its shapes and finite values.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.data import edgelist as j_edgelist  # noqa: E402
from graphneuralnetwork_tpu.models import embedding as j_emb  # noqa: E402
from graphneuralnetwork_tpu.nn import embed as j_nn  # noqa: E402
from graphneuralnetwork_tpu.train import metrics as j_metrics  # noqa: E402
from graphneuralnetwork_tpu_torch.data import edgelist as t_edgelist  # noqa: E402
from graphneuralnetwork_tpu_torch.models import embedding as t_emb  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import embed as t_nn  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import embed_loop as t_loop  # noqa: E402
from graphneuralnetwork_tpu_torch.train import metrics as t_metrics  # noqa: E402

#: forwards and gradients: max |port - JAX| over the output's max |JAX|
SCALE_TOL = 1e-6
#: the host loops' mean epoch losses, 2 epochs
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
#: the host loops' final tables (entries ~0.01-0.1)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
V, D, B, L = 40, 16, 12, 9


def _close(got, want, tol=SCALE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, V, B).astype(np.int32)
    ctx = rng.integers(0, V, (B, L)).astype(np.int32)
    labels = (rng.random((B, L)) < 0.3).astype(np.float32)
    mask = (rng.random((B, L)) < 0.8).astype(np.float32)
    mask[0] = 0.0                       # a row without a valid entry
    return centers, ctx, labels, mask


@pytest.mark.parametrize("masked", [True, False])
def test_masked_sigmoid_bce_equals_jax(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((B, L))).astype(np.float32)
    _, _, labels, mask = _batch()
    m = mask if masked else None
    got = t_metrics.masked_sigmoid_bce(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m))
    want = j_metrics.masked_sigmoid_bce(jnp.asarray(logits),
                                        jnp.asarray(labels), m)
    _close(got.numpy(), np.asarray(want))


def _grads(tm):
    return {k: p.grad.numpy() for k, p in tm.named_parameters()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("kind", ["skipgram", "line"])
def test_tables_forward_and_grads_equal_flax(kind):
    centers, ctx, labels, mask = _batch()
    weights = np.linspace(0.5, 1.5, B).astype(np.float32)
    jm = (j_nn.SkipGram if kind == "skipgram" else j_nn.LINE)(V, D)
    tm = (t_nn.SkipGram if kind == "skipgram" else t_nn.LINE)(V, D)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(centers),
                     jnp.asarray(ctx))["params"]
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))

    def jloss(p):
        out = jm.apply({"params": p}, centers, ctx)
        if kind == "skipgram":
            return j_metrics.masked_sigmoid_bce(out, labels, mask), out
        return (j_metrics.masked_sigmoid_bce(out[0], labels, mask)
                + j_metrics.masked_sigmoid_bce(out[1] * weights[:, None],
                                               labels, mask)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tc, tx = torch.from_numpy(centers), torch.from_numpy(ctx)
    args = (torch.from_numpy(labels), torch.from_numpy(mask))
    if kind == "skipgram":
        tl, _ = t_loop.skipgram_loss(tm, tc, tx, *args)
        outs = [(tm(tc, tx), jout)]
    else:
        tl, _ = t_loop.line_loss(tm, tc, tx, *args,
                                 torch.from_numpy(weights))
        outs = list(zip(tm(tc, tx), jout))
    tl.backward()
    for got, want in outs:
        _close(got.detach().numpy(), want)
    _close(tl.detach().numpy(), np.asarray(jl))
    flat = _flat(jg)
    for k, g in _grads(tm).items():
        _close(g, flat[k])


def test_sdne_forward_and_grads_equal_flax():
    n, hidden, alpha, beta = 30, (20, 8), 1e-2, 5.0
    rng = np.random.default_rng(2)
    rows = (rng.random((B, n)) < 0.2).astype(np.float32)
    sub = (rng.random((B, B)) < 0.3).astype(np.float32)
    sub_l = (np.diag(sub.sum(1)) - sub).astype(np.float32)
    jm, tm = j_nn.SDNE(n, hidden), t_nn.SDNE(n, hidden)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((2, n)))["params"]
    state = from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)

    def jloss(p):
        y, x_hat = jm.apply({"params": p}, rows)
        return (j_nn.sdne_loss_first(y, rows, sub_l, alpha)
                + j_nn.sdne_loss_second(x_hat, rows, beta)), (y, x_hat)

    (jl, (jy, jx)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    ty, tx = tm(torch.from_numpy(rows))
    tl = (t_nn.sdne_loss_first(ty, torch.from_numpy(sub_l), alpha)
          + t_nn.sdne_loss_second(tx, torch.from_numpy(rows), beta))
    tl.backward()
    _close(ty.detach().numpy(), jy)
    _close(tx.detach().numpy(), jx)
    _close(tl.detach().numpy(), np.asarray(jl))
    flat = from_flax(jax.tree.map(np.asarray, jg))
    for k, g in _grads(tm).items():
        _close(g, flat[k].numpy())


# ---------------------------------------------------------------- host loops

N_NODES = 60


def _data():
    return (j_edgelist.synthetic_smallworld(n_nodes=N_NODES, seed=1),
            t_edgelist.synthetic_smallworld(n_nodes=N_NODES, seed=1))


@pytest.fixture
def jax_init(monkeypatch):
    """JAX's initial parameters of a model, handed to the port in place of
    its own draw: ``jax_init(flax_params)``."""
    def use(params):
        state = from_flax(jax.tree.map(np.asarray, params))
        monkeypatch.setattr(t_loop, "_init_params",
                            lambda model, seed: model.load_state_dict(state))
    return use


def _skipgram_init(vocab, dim, bs, ctx_len, seed):
    """What JAX's ``train_skipgram`` initialises: flax's init depends on
    the key and the input shapes only."""
    return j_nn.SkipGram(vocab, dim).init(
        jax.random.PRNGKey(seed), jnp.zeros((bs,), jnp.int32),
        jnp.zeros((bs, ctx_len), jnp.int32))["params"]


def _check(thist, jhist, tab, jab):
    assert len(thist) == len(jhist) == 2
    np.testing.assert_allclose([h[1:] for h in thist],
                               [h[1:] for h in jhist], **LOSS_TOL)
    assert thist[-1][1] < thist[0][1]
    np.testing.assert_allclose(tab, jab, **TABLE_TOL)


def _walk_embedder_follows_jax(model, jax_init):
    kw = dict(num_walks=5, walk_length=6, embed_dim=D, batch_size=32,
              epochs=2, seed=0, window=3, subsample_t=None)
    ctx_len = 2 * 3 + 5 * 2 * 3
    jax_init(_skipgram_init(N_NODES, D, 32, ctx_len, 0))
    jd, td = _data()
    jemb, jhist = getattr(j_emb, f"run_{model}")(
        jd, j_emb.WalkEmbedConfig(**kw))
    temb, thist = getattr(t_emb, f"run_{model}")(
        td, t_emb.WalkEmbedConfig(**kw), device="cpu")
    _check(thist, jhist, temb, np.asarray(jemb))


@pytest.mark.parametrize("model", ["deepwalk", "node2vec", "struc2vec"])
def test_walk_embedders_host_loop_follow_jax(model, jax_init, monkeypatch):
    from graphneuralnetwork_tpu.sampling import native as j_native
    from graphneuralnetwork_tpu_torch.sampling import struc2vec as t_s2v
    for mod in (j_emb, t_emb):
        monkeypatch.setattr(mod, "uniform_walks", functools.partial(
            mod.uniform_walks, use_native=False))
    monkeypatch.setattr(j_native, "struc2vec_distances_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(t_s2v.native, "struc2vec_distances_native",
                        t_s2v._numpy_distances)
    _walk_embedder_follows_jax(model, jax_init)


@pytest.mark.parametrize("model", ["deepwalk", "struc2vec"])
def test_walk_embedders_on_the_engines_follow_jax(model, jax_init):
    """At the defaults DeepWalk's walks and Struc2Vec's distances come from
    each package's C++ engine: the same corpus, the same losses."""
    _walk_embedder_follows_jax(model, jax_init)


def test_line_host_loop_follows_jax(jax_init):
    kw = dict(embed_dim=D, num_negatives=3, batch_size=8, epochs=2, seed=0)
    jd, td = _data()
    max_deg = int(np.bincount(td.senders).max())
    jax_init(j_nn.LINE(N_NODES, D).init(
        jax.random.PRNGKey(0), jnp.zeros((8,), jnp.int32),
        jnp.zeros((8, 4 * max_deg), jnp.int32))["params"])
    jemb, jhist = j_emb.run_line(jd, j_emb.LINEConfig(**kw))
    temb, thist = t_emb.run_line(td, t_emb.LINEConfig(**kw), device="cpu")
    _check(thist, jhist, temb, np.asarray(jemb))


def test_sdne_host_loop_follows_jax(jax_init):
    kw = dict(hidden_dims=(32, D), batch_size=8, epochs=2, seed=0)
    jd, td = _data()
    jax_init(j_nn.SDNE(N_NODES, (32, D)).init(
        jax.random.PRNGKey(0), jnp.zeros((2, N_NODES)))["params"])
    jemb, jhist = j_emb.run_sdne(jd, j_emb.SDNEConfig(**kw))
    temb, thist = t_emb.run_sdne(td, t_emb.SDNEConfig(**kw), device="cpu")
    assert len(thist) == len(jhist) == 2
    np.testing.assert_allclose([h[1] for h in thist],
                               [h[1] for h in jhist], **LOSS_TOL)
    assert thist[-1][1] < thist[0][1]
    np.testing.assert_allclose(temb, np.asarray(jemb), **TABLE_TOL)


# ---------------------------------------------------------------- device loop

def _corpus(n=100, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, V, n).astype(np.int32)
    ctx = rng.integers(0, V, (n, L)).astype(np.int32)
    labels = np.zeros((n, L), np.float32)
    labels[:, :3] = 1.0
    return centers, ctx, labels, np.ones((n, L), np.float32)


@pytest.mark.parametrize("kind", ["skipgram", "line"])
def test_device_loop_runs_on_the_cpu(kind):
    arrays = _corpus()
    if kind == "skipgram":
        model, extra, kw = t_nn.SkipGram(V, D), (), {}
    else:
        model, extra = t_nn.LINE(V, D), (np.ones(100, np.float32),)
        kw = dict(step_fn_factory=t_loop.make_line_step,
                  device_loss_fn=t_loop.line_loss)
    params, hist = t_loop.train_skipgram(
        model, arrays, epochs=3, batch_size=16, lr=1e-2, device="cpu",
        device_loop=True, extra_batch_arrays=extra, **kw)
    assert [h[0] for h in hist] == [1, 2, 3]
    assert np.isfinite([h[1:] for h in hist]).all()
    assert hist[-1][1] < hist[0][1]
    table = params["center" if kind == "skipgram" else "vertex"]
    assert table.shape == (V, D) and torch.isfinite(table).all()


def test_captured_epochs_on_the_cpu_steps_every_batch():
    """``CapturedEpochs`` on the CPU: ``nb`` steps an epoch over the first
    ``nb * batch_size`` rows of a fresh permutation each epoch; the same
    generator seed gives the same rows."""
    seen = []

    def step(sel):
        seen.append(sel.clone())
        return torch.stack([sel.float().mean(), torch.zeros(())])

    def loop(seed):
        gen = torch.Generator().manual_seed(seed)
        return t_loop.CapturedEpochs(step, 50, 8, 2, None, gen,
                                     torch.device("cpu"))

    a = loop(5)
    rows = a.run()
    assert rows.shape == (6, 2) and len(seen) == 6
    drawn = torch.cat(seen)
    assert len(set(drawn.tolist())) == 48
    again = loop(5).run()
    np.testing.assert_array_equal(rows, again)
    assert not np.array_equal(a.run(), rows)
    with pytest.raises(ValueError, match="no batch"):
        t_loop.CapturedEpochs(step, 7, 8, 2, None, torch.Generator(),
                              torch.device("cpu"))


def test_sdne_device_loop_runs_on_the_cpu():
    cfg = t_emb.SDNEConfig(hidden_dims=(16, 8), batch_size=8, epochs=2)
    n = 40
    model, opt = t_emb.sdne_model(n, cfg, torch.device("cpu"))
    a = (torch.rand(n, n, generator=torch.Generator().manual_seed(0))
         < 0.2).float()
    loop = t_emb.sdne_epochs(model, opt, cfg, a)
    first, second = loop.run(), loop.run()
    assert first.shape == (5, 1) and np.isfinite(first).all()
    assert second.mean() < first.mean()


def test_custom_step_without_device_loss_raises():
    with pytest.raises(ValueError, match="device_loss_fn"):
        t_loop.train_skipgram(
            t_nn.LINE(V, D), _corpus(), epochs=1, batch_size=16, lr=1e-2,
            device="cpu", device_loop=True,
            step_fn_factory=t_loop.make_line_step,
            extra_batch_arrays=(np.ones(100, np.float32),))


def test_tiny_corpus_takes_the_host_loop():
    """Fewer rows than one batch: the host loop, which takes no step (as
    in JAX), so the history holds zeros."""
    params, hist = t_loop.train_skipgram(
        t_nn.SkipGram(V, D), _corpus(n=10), epochs=2, batch_size=16,
        lr=1e-2, device="cpu", device_loop=True)
    assert hist == [(1, 0.0, 0.0), (2, 0.0, 0.0)]
    assert params["center"].shape == (V, D)


@pytest.mark.parametrize("kind", ["skipgram", "line"])
def test_spread_padding_keeps_loss_and_grads(kind):
    """The padded slots' ids spread over the vocabulary: the loss and every
    gradient bit for bit as with id 0 (one thread: the CPU's accumulation
    is then in a fixed order)."""
    centers, ctx, labels, mask = (torch.from_numpy(a) for a in _batch(4))
    weights = torch.linspace(0.5, 1.5, B)
    spread = t_loop.spread_padding(ctx.long(), mask, V)
    assert (spread[mask > 0] == ctx.long()[mask > 0]).all()
    assert len(set(spread[mask == 0].tolist())) > 1
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = []
        for ids in (ctx.long(), spread):
            model = (t_nn.SkipGram if kind == "skipgram" else t_nn.LINE)(V, D)
            model.reset_parameters(torch.Generator().manual_seed(0))
            if kind == "skipgram":
                loss, acc = t_loop.skipgram_loss(model, centers, ids, labels,
                                                 mask)
            else:
                loss, acc = t_loop.line_loss(model, centers, ids, labels,
                                             mask, weights)
            loss.backward()
            out.append((loss, acc, _grads(model)))
    finally:
        torch.set_num_threads(threads)
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])
