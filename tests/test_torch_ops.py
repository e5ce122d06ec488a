"""Parity of the PyTorch port's ops (their plain CPU versions) with the JAX
package's ops on the CPU. Tolerance in float32: rtol 1e-5, atol 1e-6 (the
two frameworks sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import ops as jops  # noqa: E402
from graphneuralnetwork_tpu.core.graph import build_graph as j_build  # noqa: E402
from graphneuralnetwork_tpu_torch import ops as tops  # noqa: E402
from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    build_graph as t_build)
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    segment_max_kernel as k2, spmm_kernel as k1)

RTOL, ATOL = 1e-5, 1e-6
N, E, H, F = 60, 400, 4, 8


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def graphs():
    """A random graph whose last 5 nodes have no incoming edges."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, N, E).astype(np.int32)
    r = rng.integers(0, N - 5, E).astype(np.int32)
    w = rng.uniform(0.1, 1.0, E).astype(np.float32)
    return j_build(s, r, N, w), t_build(s, r, N, w, device="cpu")


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pad_zero(v, g):
    v = v.copy()
    v[g.n_edges:] = 0.0
    return v


@pytest.mark.parametrize("shape", [(F,), (1,), ()])
def test_aggregate_edges_forward_and_grad(graphs, shape):
    """The port ignores the padding edges' values (here non-zero) and gives
    them a zero gradient; JAX sums them, so it gets zero padding."""
    jg, tg = graphs
    vals = _rand(jg.n_edge_pad, *shape)
    cot = _rand(N, *shape, seed=1)

    def jloss(v):
        return jnp.sum(jops.aggregate_edges(jg, v) * cot)

    jvals = jnp.asarray(_pad_zero(vals, jg))
    jout = jops.aggregate_edges(jg, jvals)
    jgrad = jax.grad(jloss)(jvals)
    tv = torch.tensor(vals, requires_grad=True)
    tout = tops.aggregate_edges(tg, tv)
    (tout * torch.from_numpy(cot)).sum().backward()
    close(tout, jout)
    close(tv.grad[:tg.n_edges], jgrad[:jg.n_edges])
    assert torch.all(tv.grad[tg.n_edges:] == 0.0)


@pytest.mark.parametrize("kernel", ["segment_sum", "segment_max"])
def test_kernel_wrappers_ignore_edges_outside_the_spans(graphs, kernel):
    """On the CPU a wrapper computes what its kernel does on the card:
    edges at or past ``row_ptr[-1]`` do not count, whatever their values."""
    _, tg = graphs
    real = torch.from_numpy(_rand(tg.n_edge_pad, H, seed=17))
    padded = real.clone()
    padded[tg.n_edges:] = 1e6
    real[tg.n_edges:] = 0.0 if kernel == "segment_sum" else -1e6
    def fn(values):
        if kernel == "segment_sum":
            return k1.segment_sum(values, tg.receivers, tg.row_ptr, N)
        return k2.segment_max(tg, values)
    out = fn(padded)
    assert torch.all(out < 1e5)      # no padding value leaked in
    torch.testing.assert_close(out, fn(real), rtol=0, atol=0)


def test_segment_sum_and_mean(graphs):
    jg, tg = graphs
    data = _rand(jg.n_edge_pad, F)
    ids_j, ids_t = jg.receivers, tg.receivers
    mask = np.array(jg.edge_mask)
    close(tops.segment_sum(torch.from_numpy(data), ids_t, N),
          jops.segment_sum(jnp.asarray(data), ids_j, N))
    for m in (None, mask):
        close(tops.segment_mean(torch.from_numpy(data), ids_t, N,
                                mask=None if m is None
                                else torch.from_numpy(m)),
              jops.segment_mean(jnp.asarray(data), ids_j, N,
                                mask=None if m is None else jnp.asarray(m)))


@pytest.mark.parametrize("masked", [False, True])
def test_segment_max_empty_segments_give_zero(graphs, masked):
    jg, tg = graphs
    data = _rand(jg.n_edge_pad, H, seed=2)
    mask = np.array(jg.edge_mask)
    jout = jops.segment_max(jnp.asarray(data), jg.receivers, N,
                            mask=jnp.asarray(mask) if masked else None)
    tout = tops.segment_max(torch.from_numpy(data), tg.receivers, N,
                            mask=torch.from_numpy(mask) if masked else None)
    close(tout, jout)
    assert np.all(tout[N - 5:N - 1].numpy() == 0.0)   # no incoming edges


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("heads", [None, H])
def test_segment_and_edge_softmax(graphs, stable, heads):
    jg, tg = graphs
    shape = (jg.n_edge_pad,) if heads is None else (jg.n_edge_pad, heads)
    scores = _rand(*shape, seed=3)
    mask = np.array(jg.edge_mask)
    cot = _rand(*shape, seed=4)
    jref = jops.segment_softmax(jnp.asarray(scores), jg.receivers, N,
                                mask=jnp.asarray(mask), stable=stable)
    tseg = tops.segment_softmax(torch.from_numpy(scores), tg.receivers, N,
                                mask=torch.from_numpy(mask), stable=stable)
    close(tseg, jref)

    def jloss(s):
        return jnp.sum(jops.edge_softmax(jg, s, stable=stable) * cot)

    jedge = jops.edge_softmax(jg, jnp.asarray(scores), stable=stable)
    jgrad = jax.grad(jloss)(jnp.asarray(scores))
    ts = torch.tensor(scores, requires_grad=True)
    tedge = tops.edge_softmax(tg, ts, stable=stable)
    (tedge * torch.from_numpy(cot)).sum().backward()
    close(tedge, jedge)
    close(ts.grad, jgrad)


def test_segment_max_kernel_sentinel_maps_to_zero(graphs):
    """K2's plain version gives -3e38 on empty rows and on rows whose
    scores are all masked; edge_softmax maps both to a 0 stabiliser."""
    _, tg = graphs
    scores = torch.from_numpy(_rand(tg.n_edge_pad, H, seed=5))
    neg = torch.finfo(torch.float32).min
    masked = torch.where(tg.edge_mask[:, None], scores, neg)
    out = k2.segment_max_plain(masked, tg.receivers, N)
    # nodes N-5..N-2 have no edges; N-1 holds only the masked padding edges
    assert torch.all(out[N - 5:] == k2.EMPTY)
    counts = torch.diff(tg.row_ptr)
    filled = counts[:-5] > 0
    ref = torch.stack([scores[tg.receivers == i].max(0).values
                       for i in range(N - 5) if counts[i] > 0])
    torch.testing.assert_close(out[:N - 5][filled], ref, rtol=0, atol=0)
    stab = torch.where(out > neg / 2, out, 0.0)
    assert torch.all(stab[N - 5:] == 0.0)


def test_segment_sum_plain_keeps_dtype_and_accumulates_in_f32(graphs):
    _, tg = graphs
    vals = torch.from_numpy(_rand(tg.n_edge_pad, F, seed=6)).bfloat16()
    n = tg.n_edges
    ref = k1.segment_sum_plain(vals[:n].float(), tg.receivers[:n], N)
    out = k1.segment_sum(vals, tg.receivers, tg.row_ptr, N)
    assert out.dtype == torch.bfloat16
    # one rounding of the float32 sum to bfloat16: within 2^-8 relative
    torch.testing.assert_close(out.float(), ref, rtol=2 ** -8, atol=1e-6)


def test_spmm_and_grads(graphs):
    jg, tg = graphs
    x = _rand(N, F, seed=8)
    cot = _rand(N, F, seed=9)

    def jloss(x, w):
        return jnp.sum(jops.spmm(jg.with_weights(w), x) * cot)

    jx = jnp.asarray(x)
    gx, gw = jax.grad(jloss, argnums=(0, 1))(jx, jg.edge_weight)
    tx = torch.tensor(x, requires_grad=True)
    tw = tg.edge_weight.clone().requires_grad_(True)
    tout = tops.spmm(tg.with_weights(tw), tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    close(tout, jops.spmm(jg, jx))
    close(tx.grad, gx)
    # the padding edges' weights do not count in the port: zero gradient
    close(tw.grad[:tg.n_edges], gw[:jg.n_edges])
    assert torch.all(tw.grad[tg.n_edges:] == 0.0)


@pytest.mark.parametrize("heads", [None, H])
def test_spmm_weighted(graphs, heads):
    jg, tg = graphs
    if heads is None:
        x, w = _rand(N, F, seed=10), _rand(jg.n_edge_pad, seed=11)
    else:
        x, w = _rand(N, heads, F, seed=10), _rand(jg.n_edge_pad, heads,
                                                   seed=11)
    w = _pad_zero(w, jg)
    close(tops.spmm_weighted(tg, torch.from_numpy(w), torch.from_numpy(x)),
          jops.spmm_weighted(jg, jnp.asarray(w), jnp.asarray(x)))


def test_spmm_coo(graphs):
    jg, tg = graphs
    x = _rand(N, F, seed=12)
    close(tops.spmm_coo(tg.senders, tg.receivers, tg.edge_weight,
                        torch.from_numpy(x), N),
          jops.spmm_coo(jg.senders, jg.receivers, jg.edge_weight,
                        jnp.asarray(x), N))
    with pytest.raises(ValueError, match="receiver-sorted"):
        tops.spmm_coo(tg.senders, tg.receivers.flip(0), tg.edge_weight,
                      torch.from_numpy(x), N)


@pytest.mark.parametrize("heads", [None, H])
def test_sddmm(graphs, heads):
    jg, tg = graphs
    shape = (N, F) if heads is None else (N, heads, F)
    a, b = _rand(*shape, seed=13), _rand(*shape, seed=14)
    close(tops.sddmm_dot(tg.senders, tg.receivers, torch.from_numpy(a),
                         torch.from_numpy(b)),
          jops.sddmm_dot(jg.senders, jg.receivers, jnp.asarray(a),
                         jnp.asarray(b)))
    fshape = (N,) if heads is None else (N, heads)
    fs, fd = _rand(*fshape, seed=15), _rand(*fshape, seed=16)
    close(tops.sddmm_additive(tg.senders, tg.receivers,
                              torch.from_numpy(fs), torch.from_numpy(fd)),
          jops.sddmm_additive(jg.senders, jg.receivers, jnp.asarray(fs),
                              jnp.asarray(fd)))
