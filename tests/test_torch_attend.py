"""The hybrid GAT attention of the PyTorch port against the JAX package.

The plain versions of K4 (``attend_online_plain``), K5 and K6
(``attend_bwd_a_plain``, ``attend_bwd_b_plain``) against the Pallas kernels
in interpret mode and against ``gat_tiled_attend``'s XLA formulation and its
``jax.grad``, with the JAX-drawn dropout masks fed to both; the dropout hash
bit for bit; ``GATConv``'s hybrid branch against flax; the CLI on the CPU.

Tolerances are the JAX package's own for its kernels against its XLA path
(``tests/test_attend_online_kernel.py``): forward ``rtol=2e-4, atol=2e-5``,
gradients ``rtol=5e-4, atol=5e-5``; both sides sum in float32 in other
orders. The model test uses ``tests/test_torch_models.py``'s tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.nn import GAT as JGAT  # noqa: E402
from graphneuralnetwork_tpu.ops import bcsr_attention as jatt  # noqa: E402
from graphneuralnetwork_tpu.ops.pallas.attend_online_kernel import (  # noqa: E402
    attend_online_pallas)
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch.cli import main  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import load_cora  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import GAT as TGAT  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import bcsr_attention as tatt  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    attend_bwd_kernel as k56, attend_online_kernel as k4)
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import (  # noqa: E402
    head_keep, head_mul, keep_thresh)
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as t_ce)

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=5e-4, atol=5e-5)
SLOPE, KEEP = 0.2, 0.6


def _community(seed, n=512, e=8192, comm=64):
    """The JAX attend tests' fixture graph
    (``tests/test_attend_online_kernel.py:_fixture``): ~90 % of the edges
    inside blocks of ``comm`` nodes."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    intra = rng.random(e) < 0.9
    base = (s // comm) * comm
    r = np.where(intra, np.minimum(base + rng.integers(0, comm, e), n - 1),
                 rng.integers(0, n, e))
    keep = s != r
    return s[keep].astype(np.int32), r[keep].astype(np.int32), n


def _graphs(seed=0, symmetric=False, fill=48):
    """Both packages' hybrid of the fixture graph."""
    s, r, n = _community(seed)
    if symmetric:
        s, r = jgraph.symmetrize(s, r)
    return (jbcsr.build_hybrid(s, r, n, min_edges_per_tile=fill,
                               symmetric=symmetric),
            tbcsr.build_hybrid(s, r, n, min_edges_per_tile=fill,
                               symmetric=symmetric, device="cpu"))


def _hub_graphs():
    """Row block 0 holds 8 dense tiles and ~2,600 remainder edges (11
    chunks of 256): the TPU kernel's 2-D grid case
    (``attend_online_kernel.py:60-61``)."""
    rng = np.random.default_rng(1)
    n = 4096
    dense_s = np.concatenate([cb * 128 + rng.integers(0, 128, 256)
                              for cb in range(1, 9)])
    bg_r = np.repeat(np.arange(n), 4)
    s = np.concatenate([dense_s, rng.integers(0, n, 3000),
                        rng.integers(0, n, bg_r.shape[0])]).astype(np.int32)
    r = np.concatenate([rng.integers(0, 128, dense_s.shape[0]),
                        rng.integers(0, 128, 3000), bg_r]).astype(np.int32)
    jh = jbcsr.build_hybrid(s, r, n)
    assert int(jh.rem_fine_cnt[0]) > 8 and int(jh.bcsr.tile_cnt[0]) > 6
    return jh, tbcsr.build_hybrid(s, r, n, device="cpu")


def _operands(n, heads, feat, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, heads, feat)).astype(np.float32),
            rng.normal(size=(n, heads)).astype(np.float32),
            rng.normal(size=(n, heads)).astype(np.float32))


def _jax_masks(jh, heads, seed):
    """The masks ``gat_tiled_attend`` draws from ``dropout_rng``, as numpy:
    the uint32 lattice and the remainder multiplier."""
    rng = jax.random.PRNGKey(seed)
    bits = jax.random.bits(jax.random.fold_in(rng, 0),
                           (jh.bcsr.tiles.shape[0], 128, 128), jnp.uint32)
    keep = jax.random.bernoulli(jax.random.fold_in(rng, 1), KEEP,
                                (jh.rem.senders.shape[0], heads))
    return rng, np.asarray(bits), np.asarray(keep.astype(jnp.float32) / KEEP)


def _t(a):
    a = np.array(a)   # a writable copy of a JAX array
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _pallas_forward(jh, x, fs, fd, bits=None, keep_mul=None):
    """``attend_online_pallas`` in interpret mode, set up as
    ``_attend_online_impl`` sets it up."""
    bg, rem = jh.bcsr, jh.rem
    n, heads, feat = x.shape
    dropping = keep_mul is not None
    if bits is None:
        bits = np.zeros((bg.tiles.shape[0], 1, 1), np.uint32)
    x2f = jatt._pad_rows(jnp.asarray(x).reshape(n, -1), bg.n_node_pad)
    fsj = jnp.asarray(fs)
    w_col = (rem.edge_weight * rem.edge_mask).astype(jnp.float32)
    out, den, m = attend_online_pallas(
        bg.tile_off, bg.tile_cnt, bg.col_ids, jh.rem_fine_off,
        jh.rem_fine_cnt, bg.tiles, jnp.asarray(bits), x2f,
        jatt._pad_rows(fsj, bg.n_node_pad).T, rem.receivers.reshape(-1, 1),
        fsj[rem.senders], w_col.reshape(-1, 1),
        jnp.asarray(x).reshape(n, -1)[rem.senders],
        None if keep_mul is None else jnp.asarray(keep_mul),
        jatt._pad_rows(jnp.asarray(fd), bg.n_node_pad), heads, feat, n,
        bg.max_tiles, jh.rem_fine_max, SLOPE, KEEP if dropping else 1.0,
        dropping, dropping, interpret=True, echunk=jbcsr.ATTEND_CHUNK)
    return (np.asarray(out[:n]), np.asarray(den[:n]), np.asarray(m[:n]))


@pytest.mark.parametrize("keep_prob", [0.1, 0.4, 0.6, 0.95])
def test_head_keep_bit_equal_jax(keep_prob):
    words = np.random.default_rng(3).integers(0, 2 ** 32, 8192,
                                              dtype=np.uint64)
    words = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                            words]).astype(np.uint32)
    assert keep_thresh(keep_prob) == int(jatt._keep_thresh(keep_prob))
    for h in (0, 1, 2, 3, 7, 31):
        assert head_mul(h) == int(jatt._head_mul(h))
        np.testing.assert_array_equal(
            head_keep(_t(words), h, keep_prob).numpy(),
            np.asarray(jatt._head_keep(jnp.asarray(words), h, keep_prob)),
            err_msg=f"head {h}")


def test_forward_plain_matches_interpret_kernel_with_dropout():
    """out, den and the shift m of the plain K4 equal the Pallas kernel's
    (interpret mode) under the JAX-drawn masks; m is NEG on rows without
    edges."""
    jh, th = _graphs()
    x, fs, fd = _operands(512, 4, 32)
    _, bits, keep_mul = _jax_masks(jh, 4, seed=11)
    jout, jden, jm = _pallas_forward(jh, x, fs, fd, bits, keep_mul)
    out, den, m = k4.attend_online(th, _t(x).reshape(512, -1), _t(fs),
                                   _t(fd), _t(bits), _t(keep_mul), SLOPE,
                                   KEEP)
    np.testing.assert_allclose(out.numpy(), jout, **FWD_TOL)
    np.testing.assert_allclose(den.numpy(), jden, **FWD_TOL)
    live = jden > 0
    np.testing.assert_allclose(m.numpy()[live], jm[live], **FWD_TOL)
    assert (m.numpy()[~live] == k4.NEG).all()
    assert k4.attend_online.launches == 0   # the CPU takes the plain version


def _attend_case(case):
    """(JAX hybrid, port hybrid, x, f_src, f_dst, dropout rng or None)."""
    if case == "hub":
        jh, th = _hub_graphs()
        x, fs, fd = _operands(4096, 2, 8, seed=4)
    else:
        jh, th = _graphs(seed=1)
        x, fs, fd = _operands(512, 4, 32, seed=1)
    if case == "extreme_logits":
        fs, fd = 50.0 * fs, 50.0 * fd
    if case == "bf16_tiles":
        th = dataclasses.replace(
            th, bcsr=dataclasses.replace(
                th.bcsr, tiles=th.bcsr.tiles.to(torch.bfloat16)),
            bcsr_t=dataclasses.replace(
                th.bcsr_t, tiles=th.bcsr_t.tiles.to(torch.bfloat16)))
    return jh, th, x, fs, fd, 21 if case == "dropout" else None


@pytest.mark.parametrize("case", ["plain", "dropout", "bf16_tiles",
                                  "extreme_logits", "hub"])
def test_forward_matches_jax_gat_tiled_attend(case):
    jh, th, x, fs, fd, seed = _attend_case(case)
    heads = x.shape[1]
    if seed is None:
        ref = jatt.gat_tiled_attend(jh, jnp.asarray(x), jnp.asarray(fs),
                                    jnp.asarray(fd))
        out = tatt.gat_tiled_attend(th, _t(x), _t(fs), _t(fd))
    else:
        rng, bits, keep_mul = _jax_masks(jh, heads, seed)
        ref = jatt.gat_tiled_attend(jh, jnp.asarray(x), jnp.asarray(fs),
                                    jnp.asarray(fd), attn_dropout=1 - KEEP,
                                    dropout_rng=rng)
        out = tatt.gat_tiled_attend(th, _t(x), _t(fs), _t(fd),
                                    attn_dropout=1 - KEEP, bits=_t(bits),
                                    keep_mul=_t(keep_mul))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_backward_plain_matches_interpret_kernels_with_dropout():
    """Plain passes A and B against the Pallas kernels (interpret mode) on
    the same operands, with the JAX-drawn masks (pass B through the
    transposed lattice and the permuted remainder multiplier)."""
    jh, th = _graphs(seed=3)
    x, fs, fd = _operands(512, 4, 32, seed=3)
    _, bits, keep_mul = _jax_masks(jh, 4, seed=13)
    n, heads, feat = x.shape
    out, den, m = k4.attend_online(th, _t(x).reshape(n, -1), _t(fs), _t(fd),
                                   _t(bits), _t(keep_mul), SLOPE, KEEP)
    m = torch.where(den > 0, m, 0.0)
    g = np.random.default_rng(7).normal(size=(n, heads, feat)).astype(
        np.float32)
    jdx, jdfs, jdfd = jatt._attend_bwd_kernels(
        jh, jnp.asarray(bits), jnp.asarray(keep_mul), jnp.asarray(x),
        jnp.asarray(fs), jnp.asarray(fd), jnp.asarray(m.numpy()),
        jnp.asarray(out.numpy()).reshape(n, heads, feat),
        jnp.asarray(den.numpy()), jnp.asarray(g), SLOPE, KEEP,
        interpret=True)
    gn, fdm3 = tatt.backward_operands(_t(g).reshape(n, -1), torch.float32,
                                      _t(fd), out, den, m)
    args = (th, _t(x).reshape(n, -1), gn, _t(fs), fdm3, _t(bits),
            _t(keep_mul), SLOPE, KEEP)
    dfd = k56.attend_bwd_a(*args)
    dx, dfs = k56.attend_bwd_b(*args)
    np.testing.assert_allclose(dfd.numpy(), np.asarray(jdfd), **BWD_TOL)
    np.testing.assert_allclose(dx.numpy().reshape(n, heads, feat),
                               np.asarray(jdx), **BWD_TOL)
    np.testing.assert_allclose(dfs.numpy(), np.asarray(jdfs), **BWD_TOL)
    assert k56.attend_bwd_a.launches == k56.attend_bwd_b.launches == 0


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_grads_match_jax_grad(symmetric, dropout):
    """d x, d f_src and d f_dst of the port's autograd function (plain
    passes A and B) against ``jax.grad`` of the XLA formulation."""
    jh, th = _graphs(seed=4, symmetric=symmetric,
                     fill=192 if symmetric else 48)
    x, fs, fd = _operands(512, 4, 32, seed=4)
    g = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    kw_j, kw_t = {}, {}
    if dropout:
        rng, bits, keep_mul = _jax_masks(jh, 4, seed=17)
        kw_j = dict(attn_dropout=1 - KEEP, dropout_rng=rng)
        kw_t = dict(attn_dropout=1 - KEEP, bits=_t(bits),
                    keep_mul=_t(keep_mul))

    def loss(a, b, c):
        return jnp.sum(jatt.gat_tiled_attend(jh, a, b, c, **kw_j) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(fs),
                                            jnp.asarray(fd))
    ins = [_t(a).clone().requires_grad_() for a in (x, fs, fd)]
    (tatt.gat_tiled_attend(th, *ins, **kw_t) * _t(g)).sum().backward()
    for name, t_in, r in zip(("dx", "dfs", "dfd"), ins, ref):
        np.testing.assert_allclose(t_in.grad.numpy(), np.asarray(r),
                                   err_msg=name, **BWD_TOL)


def test_draw_dropout_operands():
    _, th = _graphs()
    gen = torch.Generator().manual_seed(0)
    bits, keep_mul = tatt.draw_dropout(th, 4, KEEP, gen)
    assert bits.dtype == torch.int32 and bits.shape == th.bcsr.tiles.shape
    assert keep_mul.shape == (th.rem.n_edge_pad, 4)
    assert set(torch.unique(keep_mul).tolist()) == {0.0,
                                                    float(np.float32(1 / KEEP))}
    assert abs(float((keep_mul > 0).float().mean()) - KEEP) < 0.01
    # the uint32 words are uniform: each head keeps about KEEP of the slots
    for h in range(4):
        assert abs(float(head_keep(bits, h, KEEP).float().mean())
                   - KEEP) < 0.01
    again = tatt.draw_dropout(th, 4, KEEP, torch.Generator().manual_seed(0))
    assert torch.equal(again[0], bits) and torch.equal(again[1], keep_mul)


N_FEATS, N_CLASSES, N_TRAIN = 48, 4, 60
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def hybrid_model_data():
    """The GAT CLI's graph on the fixture graph (symmetrised, self loops,
    unit weights) in both packages; random features and labels."""
    s, r, n = _community(seed=2)
    s2, r2 = jgraph.add_self_loops(*jgraph.symmetrize(s, r), n)
    jg = jbcsr.build_hybrid(s2, r2, n, symmetric=True)
    tg = tgraph.gat_graph_hybrid(s, r, n, device="cpu")
    assert tg.bcsr.n_tiles > 1 and tg.rem.n_edges > 0
    rng = np.random.default_rng(2)
    x = rng.random((n, N_FEATS)).astype(np.float32)
    x /= x.sum(1, keepdims=True)
    return jg, tg, x, rng.integers(0, N_CLASSES, n).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gat_on_hybrid_matches_flax(dtype, hybrid_model_data):
    """GAT (8 heads x 4, then 1 x classes) on the hybrid layout: the same
    weights (``params.from_flax``), dropout off, equal logits and parameter
    gradients; bfloat16 is held to the scaled tolerance of
    ``tests/test_torch_models.py``."""
    jg, tg, x, labels = hybrid_model_data
    bf16 = dtype == "bfloat16"
    jm = JGAT(hidden=4, num_heads=8, num_classes=N_CLASSES,
              dtype=jnp.bfloat16 if bf16 else None)
    tm = TGAT(N_FEATS, hidden=4, num_heads=8, num_classes=N_CLASSES,
              dtype=torch.bfloat16 if bf16 else None)
    params = jm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))["params"]

    def jloss(p):
        logits = jm.apply({"params": p}, jg, jnp.asarray(x))
        return j_ce(logits[:N_TRAIN], jnp.asarray(labels[:N_TRAIN])), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    jgrads = from_flax(jax.tree.map(np.asarray, jgrads))
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tm.eval()
    tlogits = tm(tg, torch.from_numpy(x))
    t_ce(tlogits[:N_TRAIN],
         torch.from_numpy(labels[:N_TRAIN].astype(np.int64))).backward()
    assert tlogits.dtype == torch.float32
    jlogits = np.asarray(jlogits)
    if not bf16:
        np.testing.assert_allclose(tlogits.detach().numpy(), jlogits,
                                   **F32_TOL)
        for name, g in jgrads.items():
            np.testing.assert_allclose(
                dict(tm.named_parameters())[name].grad.numpy(), g.numpy(),
                err_msg=name, **F32_TOL)
        return
    scale = float(np.abs(jlogits).max())
    np.testing.assert_allclose(tlogits.detach().numpy() / scale,
                               jlogits / scale, **BF16_TOL)
    gs = max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(
            dict(tm.named_parameters())[name].grad.numpy() / gs,
            g.numpy() / gs, err_msg=name, **BF16_TOL)


def test_gat_hybrid_dropout_draws_from_the_generator(hybrid_model_data):
    """Training mode on the hybrid layout: attention and feature dropout
    come only from the generator passed in."""
    _, tg, x, _ = hybrid_model_data
    tm = TGAT(N_FEATS, hidden=4, num_heads=8, num_classes=N_CLASSES)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    tm.train()
    xs = torch.from_numpy(x)

    def run(seed):
        return tm(tg, xs, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    tm.eval()
    torch.testing.assert_close(tm(tg, xs), tm(tg, xs), rtol=0, atol=0)


def test_gat_hybrid_matches_coo_on_cora():
    """GAT at the CLI's widths on Cora's hybrid layout (tiles, K4-K6 plain
    versions) against the same weights on the COO layout (edge softmax,
    K1/K2 plain versions): a relabelling of one computation, so the logits
    and every parameter's gradient, each against its own largest entry,
    agree within float32 summation-order noise."""
    def run(data):
        model = TGAT(int(data.features.shape[1]), hidden=8, num_heads=8,
                     num_classes=data.num_classes)
        model.reset_parameters(torch.Generator().manual_seed(1))
        model.eval()
        logits = model(data.graph, data.features)
        t_ce(logits[data.train_idx], data.labels[data.train_idx]).backward()
        # train_idx maps the original nodes 0..139 through the relabelling
        return (logits[data.train_idx].detach(),
                {k: p.grad for k, p in model.named_parameters()})

    coo = load_cora(seed=0, layout="coo", device="cpu")
    hyb = load_cora(seed=0, layout="auto", layout_objective="attention",
                    device="cpu", model="gat")
    assert hasattr(hyb.graph, "bcsr")
    (lc, gc), (lh, gh) = run(coo), run(hyb)
    assert float((lh - lc).abs().max()) <= 1e-5 * float(lc.abs().max())
    for name, g in gc.items():
        err = float((gh[name] - g).abs().max()) / float(g.abs().max())
        assert err <= 1e-5, (name, err)


def test_cli_gat_auto_layout_trains_on_cpu():
    """``--model gat`` under the default ``--layout auto`` takes the hybrid
    layout on Cora and reaches the REPRO criterion (test_acc >= 0.80)."""
    res = main(["--model", "gat", "--epochs", "50", "--device", "cpu",
                "--quiet"])
    assert res["epochs"] == 50 and np.isfinite(res["loss"])
    assert res["test_acc"] >= 0.80, res["test_acc"]
