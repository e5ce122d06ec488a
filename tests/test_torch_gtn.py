"""GTN of the PyTorch port against the JAX package on the CPU: the
precision/recall metrics, the GTN loaders (synthetic, ``train.pkl`` and
``ACM.mat``), the dense ``GTConv``/``GTLayer``/``GTN`` and the wedge-plan
``SparseGTN`` against flax from the same parameters (``params.from_flax``),
the plan's arrays, the blocked composition, the captured chunk
(``GTNBlock``) under ``test_torch_capture.StubGraph`` and the ``gtn`` CLI,
whose per-epoch losses follow JAX's ``cli.main`` from JAX's initial
parameters.

Tolerances, each against the largest entry of the output it holds, or for
a parameter's gradient the largest gradient entry of its module (a
Linear's weight and bias together): float32 outputs ``F32_FWD`` = 2e-5 and
gradients ``F32_GRAD`` = 1e-4 (both sides sum in float32 in other orders;
the sparse model sums a composition by edge type first); bfloat16
``BF16`` = 3e-2 (both round the same bfloat16 products, whose float32 sums
may round to neighbouring bfloat16 values), the gradients against JAX's
bfloat16 gradients: on the fixture both packages' bfloat16 gradients lie
up to ~11 % of their scale from the float32 ones and within ~1.2 % of
each other. The port's
sparse model against its dense model: JAX's own test's tolerance
(``tests/test_models.py``: 2e-4 of the logits). The CLI's losses
``LOSS_TOL`` = 1e-4 relative.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.data import acm as jacm  # noqa: E402
from graphneuralnetwork_tpu.nn import gtn as jgtn  # noqa: E402
from graphneuralnetwork_tpu.nn import gtn_sparse as jsparse  # noqa: E402
from graphneuralnetwork_tpu.train import metrics as jmetrics  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.data import acm as tacm  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import gtn as tgtn  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import gtn_sparse as tsparse  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import gtn_loop  # noqa: E402
from graphneuralnetwork_tpu_torch.train import (  # noqa: E402
    metrics as tmetrics)
from graphneuralnetwork_tpu_torch.train import scan_loop  # noqa: E402
from test_real_formats import write_acm_mat  # noqa: E402
from test_torch_capture import (  # noqa: E402, F401 (fixtures)
    StubGraph, counted, one_thread)

F32_FWD, F32_GRAD, BF16, DENSE_SPARSE, LOSS_TOL = 2e-5, 1e-4, 3e-2, 2e-4, 1e-4
N, T, FEATS, CLASSES, HIDDEN = 60, 4, 16, 3, 8


def _close(got, want, tol, what):
    """``|got - want| <= tol * max|want|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} of scale {scale}"


def _close_grads(got: dict, want: dict, tol):
    """Each gradient against its module's largest gradient entry."""
    scale = {}
    for k, g in want.items():
        module = k.rpartition(".")[0]
        scale[module] = max(scale.get(module, 0.0), float(np.abs(g).max()))
    for k, g in want.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - g).max())
        assert err <= tol * scale[k.rpartition(".")[0]], (k, err)


def _flat(tree) -> dict:
    """A flax gradient tree in the port's names and layout."""
    return {k: v.numpy() for k, v in
            from_flax(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def stack():
    """JAX's sparse-vs-dense fixture: three random edge types over 60
    nodes and the identity, 16 features."""
    rng = np.random.default_rng(0)
    adj = np.zeros((T, N, N), np.float32)
    for t in range(T - 1):
        e = rng.integers(0, N, (2, 150))
        adj[t][e[0], e[1]] = 1.0
    adj[T - 1] = np.eye(N, dtype=np.float32)
    x = rng.normal(size=(N, FEATS)).astype(np.float32)
    model = jgtn.GTN(num_classes=CLASSES, channels=2, num_layers=2,
                     hidden=HIDDEN)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(adj),
                        jnp.asarray(x))["params"]
    return adj, x, params


# ----------------------------------------------------------- metrics


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("masked", [False, True])
def test_precision_recall_fbeta_matches_jax(average, masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(50, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 50)
    mask = (rng.random(50) < 0.6).astype(np.float32) if masked else None
    want = jmetrics.precision_recall_fbeta(
        jnp.asarray(logits), jnp.asarray(labels), 4,
        None if mask is None else jnp.asarray(mask), beta=0.5,
        average=average)
    got = tmetrics.precision_recall_fbeta(
        torch.from_numpy(logits), torch.from_numpy(labels), 4,
        None if mask is None else torch.from_numpy(mask), beta=0.5,
        average=average)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=1e-6)


def test_confusion_counts_match_jax():
    rng = np.random.default_rng(2)
    pred, labels = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    mask = (rng.random(40) < 0.5).astype(np.float32)
    want = jmetrics.confusion_counts(jnp.asarray(pred), jnp.asarray(labels),
                                     3, jnp.asarray(mask))
    got = tmetrics.confusion_counts(torch.from_numpy(pred),
                                    torch.from_numpy(labels), 3,
                                    torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------- loaders


def _same_data(td, jd):
    for name in ("adj", "features", "labels", "target_idx", "train_idx",
                 "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)),
                                      err_msg=name)
    assert td.num_classes == jd.num_classes
    assert td.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["acm", "imdb"])
def test_gtn_loaders_match_jax(name):
    """The synthetic ACM (920 nodes) and IMDB stacks, array for array."""
    if name == "acm":
        td, jd = tacm.load_acm_gtn(seed=0, device="cpu"), jacm.load_acm_gtn(
            seed=0)
        assert td.adj.shape == (5, 920, 920)
        assert [len(td.train_idx), len(td.val_idx), len(td.test_idx)] == [
            573, 24, 3]
    else:
        td, jd = tacm.load_imdb_gtn(seed=0, device="cpu"), jacm.load_imdb_gtn(
            seed=0)
    _same_data(td, jd)


@pytest.mark.parametrize("kind", ["pkl", "mat"])
def test_gtn_file_loaders_match_jax(kind, tmp_path):
    """The reference's ``train.pkl`` (``_load_gtn_pickle``) and an
    ACM.mat, each written here."""
    if kind == "pkl":
        from scipy import sparse as sp
        rng = np.random.default_rng(0)
        n = 30
        edges = [sp.random(n, n, density=0.2, random_state=i, format="csr")
                 for i in range(4)]
        path = str(tmp_path / "train.pkl")
        with open(path, "wb") as f:
            pickle.dump((np.arange(n), rng.integers(0, 3, n), edges,
                         rng.random((n, 8)).astype(np.float32)), f)
        _same_data(tacm.load_imdb_gtn(path, seed=1, device="cpu"),
                   jacm.load_imdb_gtn(path, seed=1))
    else:
        path = str(tmp_path / "ACM.mat")
        write_acm_mat(path)
    _same_data(tacm.load_acm_gtn(path, seed=3, per_class_train=5,
                                 per_class_val=3, device="cpu"),
               jacm.load_acm_gtn(path, seed=3, per_class_train=5,
                                 per_class_val=3))


def test_gtn_loader_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tacm.load_acm_gtn()


# ----------------------------------------------------------- dense GTN


def _dtypes(dtype):
    return ((None, None) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _module_case(kind, adj, x, dtype):
    """(flax module, its call, port module, its call, inputs) of a module
    case; the inputs are a list of numpy arrays, the first the stack."""
    jd, td = _dtypes(dtype)
    rng = np.random.default_rng(4)
    h_prev = rng.random((2, N, N)).astype(np.float32)
    if kind == "gtconv":
        return (jgtn.GTConv(2), lambda m, p, a: m.apply({"params": p}, a),
                tgtn.GTConv(2, T), lambda m, a: m(a), [adj])
    if kind in ("gtlayer_first", "gtlayer_next"):
        first = kind == "gtlayer_first"
        args = [adj] if first else [adj, h_prev]
        return (jgtn.GTLayer(2, first=first),
                lambda m, p, *a: m.apply({"params": p}, *a),
                tgtn.GTLayer(2, T, first=first), lambda m, *a: m(*a), args)
    return (jgtn.GTN(num_classes=CLASSES, hidden=HIDDEN, dtype=jd),
            lambda m, p, a, xx: m.apply({"params": p}, a, xx,
                                        return_weights=True),
            tgtn.GTN(FEATS, T, CLASSES, hidden=HIDDEN, dtype=td),
            lambda m, a, xx: m(a, xx, return_weights=True), [adj, x])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gtconv", "gtlayer_first", "gtlayer_next",
                                  "gtn"])
def test_dense_gtn_modules_match_flax(kind, dtype, stack):
    """Forward (the GTN's logits and its last composed adjacency) and the
    gradients of a random projection of every output, to the parameters
    and to ``h_prev``, against flax from the same parameters. A module
    below the model takes its input in ``dtype``; the model casts."""
    adj, x, _ = stack
    jmod, jcall, tmod, tcall, inputs = _module_case(kind, adj, x, dtype)
    jd, td = _dtypes(dtype)
    if kind != "gtn" and jd is not None:
        inputs = [i.astype(jnp.bfloat16) for i in inputs]
    params = jmod.init(jax.random.PRNGKey(1), *inputs)["params"]
    tmod.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    outs = jcall(jmod, params, *inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(5)
    proj = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def jloss(p, *a):
        o = jcall(jmod, p, *a)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(oo.astype(jnp.float32) * pp)
                   for oo, pp in zip(o, proj))

    j_grads = jax.grad(jloss, argnums=tuple(range(len(inputs) + 1)))(
        params, *inputs)
    t_in = [torch.from_numpy(np.asarray(i, np.float32)) for i in inputs]
    if kind != "gtn" and td is not None:
        t_in = [i.to(td) for i in t_in]
    t_in = [i.requires_grad_(k > 0) for k, i in enumerate(t_in)]
    t_outs = tcall(tmod, *t_in)
    t_outs = t_outs if isinstance(t_outs, tuple) else (t_outs,)
    fwd_tol = F32_FWD if jd is None else BF16
    for k, (g, w) in enumerate(zip(t_outs, outs)):
        assert g.dtype == (torch.float32 if (kind == "gtn" and k == 0)
                           or td is None else td)
        _close(g.float().detach(), np.asarray(w, np.float32), fwd_tol,
               f"{kind} output {k}")
    sum((o.float() * torch.from_numpy(p)).sum()
        for o, p in zip(t_outs, proj)).backward()
    grad_tol = F32_GRAD if jd is None else BF16
    _close_grads({k: p.grad.numpy() for k, p in tmod.named_parameters()},
                 _flat(j_grads[0]), grad_tol)
    if kind == "gtlayer_next":
        _close(t_in[1].grad.float(), np.asarray(j_grads[2], np.float32),
               grad_tol, "d h_prev")


def test_from_flax_serves_both_models(stack):
    """One flax tree maps onto the dense and the sparse model's state
    dicts, names and shapes (``GTConv`` weights [C, T] unchanged)."""
    _, _, params = stack
    sd = from_flax(jax.tree.map(np.asarray, params))
    for model in (tgtn.GTN(FEATS, T, CLASSES, hidden=HIDDEN),
                  tsparse.SparseGTN(FEATS, T, CLASSES, hidden=HIDDEN)):
        own = model.state_dict()
        assert {k: tuple(v.shape) for k, v in own.items()} == {
            k: tuple(v.shape) for k, v in sd.items()}
        model.load_state_dict(sd)
    assert sd["gt0.conv1.weight"].shape == (2, T)
    np.testing.assert_array_equal(sd["gcn_w.weight"].numpy(),
                                  np.asarray(params["gcn_w"]["kernel"]).T)


# ----------------------------------------------------------- the plan


@pytest.fixture(scope="module")
def acm_stack():
    return np.asarray(jacm.load_acm_gtn(seed=0).adj)


def _plans(adj):
    n = adj.shape[1]
    return (tsparse.build_gtn_plan(tsparse.stacked_adj_to_sparse(adj), n,
                                   device="cpu"),
            jsparse.build_gtn_plan(jsparse.stacked_adj_to_sparse(adj), n))


@pytest.mark.parametrize("which", ["fixture", "acm920"])
def test_build_gtn_plan_matches_jax(which, stack, acm_stack):
    """Every array of the plan equals JAX's, exactly; the 920-node ACM
    plan has the sizes of the CLI's sparse run."""
    adj = stack[0] if which == "fixture" else acm_stack
    tp, jp = _plans(adj)
    for name in ("base_idx", "base_val", "step_h_idx", "step_type",
                 "step_a_val", "step_out", "step_row", "step_diag"):
        got, want = getattr(tp, name), getattr(jp, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
    for name in ("final_edge_pos", "final_diag"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    for name in ("senders", "receivers", "edge_weight", "chunk_off",
                 "chunk_cnt"):
        np.testing.assert_array_equal(
            getattr(tp.final_graph, name).numpy(),
            np.asarray(getattr(jp.final_graph, name)), err_msg=name)
    assert (tp.nnz, tp.wedge_counts, tp.n_nodes, tp.n_types) == (
        jp.nnz, jp.wedge_counts, jp.n_nodes, jp.n_types)
    assert tp.final_graph.n_edges == int(jp.final_graph.n_edges)
    if which == "acm920":
        assert tp.nnz == (5130, 34828, 128256)
        assert tp.wedge_counts == (44766, 220249)
        assert tp.final_graph.n_edge_pad == 129024


def test_plan_orders_sort_the_reference_wedges(stack):
    """``step_fwd`` is the stable sort of the reference's wedges by
    (output slot, type) and ``step_bwd`` by H slot, each with its CSR
    offsets on the device and on the host."""
    tp, _ = _plans(stack[0])
    for s in range(len(tp.step_h_idx)):
        h, t = tp.step_h_idx[s], tp.step_type[s]
        a, o = tp.step_a_val[s], tp.step_out[s]
        rows = o.astype(np.int64) * tp.n_types + t
        for order, key, src, n_rows in (
                (tp.step_fwd[s], rows, h, tp.nnz[s + 1] * tp.n_types),
                (tp.step_bwd[s], h, rows, tp.nnz[s])):
            perm = np.argsort(key, kind="stable")
            g, w = order.graph, len(h)
            assert (g.n_edges, g.n_nodes) == (w, n_rows)
            np.testing.assert_array_equal(g.senders[:w].numpy(), src[perm])
            np.testing.assert_array_equal(g.receivers[:w].numpy(),
                                          key[perm])
            np.testing.assert_array_equal(g.edge_weight[:w].numpy(),
                                          a[perm])
            np.testing.assert_array_equal(order.ptr, g.row_ptr.numpy())
            assert order.ptr[-1] == w


def test_build_gtn_plan_refuses_without_identity_or_over_max_wedges():
    rng = np.random.default_rng(0)
    n = 40
    adjs = []
    for _ in range(2):
        s, r = rng.integers(0, n, 100), rng.integers(0, n, 100)
        keep = s != r                      # no self loops anywhere
        adjs.append((s[keep], r[keep], np.ones(keep.sum(), np.float32)))
    with pytest.raises(ValueError, match="identity"):
        tsparse.build_gtn_plan(adjs, n, device="cpu")
    loops = np.arange(n)
    with pytest.raises(ValueError, match="max_wedges"):
        tsparse.build_gtn_plan(adjs + [(loops, loops, np.ones(n))], n,
                               max_wedges=10, device="cpu")


def test_blocks_cut_whole_rows():
    """Blocks cover the rows in order, each within the limit or one row
    that alone exceeds it."""
    ptr = np.concatenate([[0], np.cumsum([3, 0, 9, 1, 1, 0, 4, 2, 2])])
    blocks = tsparse._blocks(ptr, 4)
    assert blocks[0][0] == 0 and blocks[-1][1] == len(ptr) - 1
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for r0, r1 in blocks:
        assert ptr[r1] - ptr[r0] <= 4 or r1 == r0 + 1
    assert (2, 3) in blocks


# ----------------------------------------------------------- sparse GTN


def _grads(model) -> dict:
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_gtn_matches_jax(dtype, stack):
    """``SparseGTN`` on the port's plan against JAX's ``SparseGTN`` on
    its own, in ``dtype``: logits and the gradients of their squares'
    sum."""
    adj, x, params = stack
    jd, td = _dtypes(dtype)
    tp, jp = _plans(adj)
    jm = jsparse.SparseGTN(num_classes=CLASSES, hidden=HIDDEN, dtype=jd)

    def jloss(p, d):
        return jnp.sum(jsparse.SparseGTN(num_classes=CLASSES, hidden=HIDDEN,
                                         dtype=d).apply(
            {"params": p}, jp, jnp.asarray(x)) ** 2)

    want = jm.apply({"params": params}, jp, jnp.asarray(x))
    want_g = _flat(jax.grad(jloss)(params, jd))
    tm = tsparse.SparseGTN(FEATS, T, CLASSES, hidden=HIDDEN, dtype=td)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    got = tm(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (N, CLASSES)
    _close(got.detach(), want, F32_FWD if jd is None else BF16, "logits")
    (got ** 2).sum().backward()
    _close_grads(_grads(tm), want_g, F32_GRAD if jd is None else BF16)


def test_sparse_gtn_matches_dense(stack):
    """The port's two models from one state dict, in float32: JAX's own
    test's tolerances (logits 2e-4, gradients 3e-3)."""
    adj, x, params = stack
    sd = from_flax(jax.tree.map(np.asarray, params))
    tp, _ = _plans(adj)
    outs = []
    for model, graph in ((tgtn.GTN(FEATS, T, CLASSES, hidden=HIDDEN),
                          torch.from_numpy(adj)),
                         (tsparse.SparseGTN(FEATS, T, CLASSES,
                                            hidden=HIDDEN), tp)):
        model.load_state_dict(sd)
        out = model(graph, torch.from_numpy(x))
        (out ** 2).sum().backward()
        outs.append((out.detach().numpy(), _grads(model)))
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=DENSE_SPARSE,
                               rtol=DENSE_SPARSE)
    for k, g in outs[0][1].items():
        np.testing.assert_allclose(outs[1][1][k], g, atol=3e-3, rtol=3e-3,
                                   err_msg=k)


def test_blocked_composition_is_bit_equal(stack, counted, one_thread):
    """``wedge_block=257`` streams each composition in blocks of whole
    rows (more K1 calls); logits and every gradient equal the unblocked
    model's bit for bit."""
    adj, x, params = stack
    sd = from_flax(jax.tree.map(np.asarray, params))
    tp, _ = _plans(adj)
    runs = []
    for block in (8_000_000, 257):
        model = tsparse.SparseGTN(FEATS, T, CLASSES, hidden=HIDDEN,
                                  wedge_block=block)
        model.load_state_dict(sd)
        counters.reset_launches()
        out = model(tp, torch.from_numpy(x))
        (out ** 2).sum().backward()
        runs.append((out, _grads(model), counters.read_launches()["K1"]))
    assert runs[0][2] == EPOCH_K1["sparse"] and runs[1][2] > runs[0][2]
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
    for k, g in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][k], g, err_msg=k)


# ----------------------------------------------------------- training


#: K1 launches of one GTN epoch, by model: forward 5 (two compositions,
#: two degree sums, the final convolution), backward 5 (the two
#: compositions' transposes, the two degree read-backs' sums, the final
#: convolution's d x over the final graph's transpose)
EPOCH_K1 = {"dense": 0, "sparse": 10}


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_gtn_block_matches_eager_under_stub_capture(kind, stack, counted,
                                                    one_thread, monkeypatch):
    """Two chunks of 3 epochs as ``GTNBlock`` (warm-up, capture, replays
    under ``StubGraph``) against ``run_gtn_epochs`` from the same state:
    equal losses, parameters and launch totals; the plan is warmed before
    the capture."""
    adj, x, _ = stack
    monkeypatch.setattr(scan_loop, "EpochGraph", StubGraph)
    data = tacm._stacked_data(
        adj, np.abs(x), np.random.default_rng(6).integers(0, CLASSES, 40),
        40, 0, 5, 3, torch.device("cpu"))
    if kind == "dense":
        graph, make = data.adj, tgtn.GTN
    else:
        graph, make = _plans(adj)[0], tsparse.SparseGTN
        warmed = []
        real_warm = tsparse.GTNPlan.warm
        monkeypatch.setattr(tsparse.GTNPlan, "warm",
                            lambda p: warmed.append(p) or real_warm(p))
    states = [gtn_loop.create_gtn_state(make(FEATS, T, CLASSES,
                                             hidden=HIDDEN), data, 0)
              for _ in range(2)]
    block = gtn_loop.GTNBlock(states[0], data, graph, 3)
    rows = [block.run(), block.run()]
    if kind == "sparse":
        assert warmed == [graph]
    launches = counters.read_launches()
    assert {k: n for k, n in launches.items() if n} == (
        {"K1": 6 * EPOCH_K1[kind]} if EPOCH_K1[kind] else {})
    counters.reset_launches()
    ref = [gtn_loop.run_gtn_epochs(states[1], data, graph, 3)
           for _ in range(2)]
    assert counters.read_launches() == launches
    for got, want in zip(rows, ref):
        assert got.shape == (3, 1) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for (k, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_create_gtn_state_groups_the_reference_way(stack):
    """Two AdamW groups: the ``gt*`` layers at 2.5e-3, ``gcn_w`` and the
    head at 5e-3, both with weight decay 1e-3."""
    adj, x, _ = stack
    data = tacm._stacked_data(adj, np.abs(x), np.arange(40) % CLASSES, 40,
                              0, 5, 3, torch.device("cpu"))
    model = tsparse.SparseGTN(FEATS, T, CLASSES, hidden=HIDDEN)
    state = gtn_loop.create_gtn_state(model, data, 0)
    names = {id(p): k for k, p in model.named_parameters()}
    groups = [(g["lr"], g["weight_decay"], sorted(names[id(p)].split(".")[0]
                                                  for p in g["params"]))
              for g in state.optimizer.param_groups]
    assert groups == [
        (2.5e-3, 1e-3, ["gt0", "gt0", "gt1"]),
        (5e-3, 1e-3, ["gcn_w", "linear1", "linear1", "linear2",
                      "linear2"])]


def _jax_cli(argv, monkeypatch):
    """JAX's ``cli.main(argv)``: its result, each chunk's losses and its
    initial parameters, read off the jitted chunk's calls."""
    real_jit = jax.jit
    calls = []

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "run_chunk":
            return jitted

        def call(params, *rest):
            out = jitted(params, *rest)
            calls.append((params, np.asarray(out[2])))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    res = jcli.main(argv)
    monkeypatch.setattr(jax, "jit", real_jit)
    return res, np.concatenate([c[1] for c in calls]), calls[0][0]


@pytest.mark.parametrize("layout", ["auto", "sparse"])
def test_cli_gtn_losses_follow_jax(layout, monkeypatch):
    """4 epochs (one chunk) on the 920-node ACM: from JAX's initial
    parameters, the port's per-epoch losses follow JAX's, and the test
    scores agree."""
    argv = ["--model", "gtn", "--epochs", "4", "--quiet", "--layout",
            layout]
    jres, jlosses, jparams = _jax_cli(argv, monkeypatch)
    real_create = gtn_loop.create_gtn_state
    monkeypatch.setattr(
        gtn_loop, "create_gtn_state",
        lambda model, data, seed: real_create(
            model, data, seed,
            params=from_flax(jax.tree.map(np.asarray, jparams))))
    losses = []
    real_run = gtn_loop.run_gtn_epochs

    def recorded(state, data, graph, n):
        rows = real_run(state, data, graph, n)
        losses.extend(rows[:, 0])
        return rows

    monkeypatch.setattr(gtn_loop, "run_gtn_epochs", recorded)
    tres = tcli.main(argv + ["--device", "cpu"])
    assert jlosses.shape == (4,) and len(losses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    for key in ("test_acc", "f1", "precision", "recall"):
        assert abs(tres[key] - jres[key]) <= 1e-6, key
    assert tres["epochs"] == 4 and tres["loss"] == losses[-1]
    assert "steady_epochs_per_s" not in tres


@pytest.mark.parametrize("argv", [
    ["--model", "gtn"],
    ["--model", "gtn", "--layout", "sparse", "--dtype", "bfloat16"],
    ["--model", "gtn", "--dataset", "imdb", "--dtype", "bfloat16"],
])
def test_cli_gtn_runs_on_cpu(argv):
    """20 epochs (two chunks): every result key, a finite loss."""
    res = tcli.main(argv + ["--epochs", "20", "--device", "cpu", "--quiet"])
    for key in ("test_acc", "f1", "precision", "recall", "seconds",
                "steady_epochs_per_s", "loss", "epochs"):
        assert key in res, key
    assert res["epochs"] == 20 and np.isfinite(res["loss"])
    assert res["device"] == "cpu" and res["steady_epochs_per_s"] > 0


@pytest.mark.parametrize("argv", [
    ["--model", "gcn", "--layout", "sparse"],
    ["--model", "han", "--layout", "sparse"],
    ["--model", "gtn", "--layout", "hybrid"],
    ["--model", "gtn", "--set", "lr=0.1"],
])
def test_cli_gtn_refusals(argv):
    with pytest.raises(SystemExit):
        tcli.main(argv + ["--device", "cpu", "--quiet"])


@pytest.mark.parametrize("layout", ["auto", "sparse"])
def test_cli_gtn_default_device_raises_without_cuda(layout, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--model", "gtn", "--layout", layout, "--epochs", "1",
                   "--quiet"])
