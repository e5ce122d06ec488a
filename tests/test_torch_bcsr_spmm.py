"""The dense-tile SpMM (K3) and the hybrid neighbour max (K7) of the
PyTorch port against the JAX package on the CPU.

K3: ``bcsr_spmm``'s plain version and autograd function against JAX's
``bcsr_spmm`` (its XLA formulation on the CPU), forward and ``dx``, on a
graph of 600 nodes (not a multiple of 128) whose third row block holds no
tile; the hybrid ``spmm`` against JAX's and against the port's own COO
``spmm`` over the same edges. K7: ``bcsr_neighbor_max`` and
``hybrid_segment_max`` against JAX, forward exact, empty rows, gradients on
tie-free inputs.

Tolerances: ``F32_TOL``/``BF16_TOL`` of ``tests/test_torch_models.py``
(float32 sums in other orders; bfloat16 outputs rounded once from float32
sums that differ in the last bits), and exact for the max forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.ops import bcsr_attention as jatt  # noqa: E402
from graphneuralnetwork_tpu.ops import spmm as j_spmm  # noqa: E402
from graphneuralnetwork_tpu.ops.bcsr_spmm import (  # noqa: E402
    bcsr_spmm as j_bcsr_spmm)
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import bcsr_attention as tatt  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import spmm as t_spmm  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.bcsr_spmm import (  # noqa: E402
    bcsr_spmm as t_bcsr_spmm)
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    bcsr_spmm_kernel as k3, neighbor_max_kernel as k7)
from graphneuralnetwork_tpu_torch.ops.cuda.attend_common import NEG  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
N, EMPTY_BLOCK, FILL = 600, 2, 64
#: nodes without any in-edge (the max's empty rows)
ISOLATED = np.arange(590, 600)


def _edges(symmetric):
    """A community graph on N nodes whose row block ``EMPTY_BLOCK`` keeps
    only 0.5 % of its in-edges, spread too thin to fill a tile, and whose
    last ten nodes receive nothing. Symmetric: symmetrised and
    sym-normalised (GCN's weights); directed: random weights."""
    rng = np.random.default_rng(0)
    e = 8000
    s = rng.integers(0, N, e)
    base = (s // 64) * 64
    r = np.where(rng.random(e) < 0.9,
                 np.minimum(base + rng.integers(0, 64, e), N - 1),
                 rng.integers(0, N, e))
    keep = (s != r) & ~((r // 128 == EMPTY_BLOCK) & (rng.random(e) < 0.995))
    s, r = s[keep].astype(np.int32), r[keep].astype(np.int32)
    if symmetric:
        s, r = jgraph.symmetrize(s, r)
    keep = ~np.isin(r, ISOLATED)
    s, r = s[keep], r[keep]
    if symmetric:
        return s, r, jgraph.sym_normalize_weights(s, r, N)
    return s, r, rng.random(len(s)).astype(np.float32) + 0.5


def _hybrids(symmetric, tile_dtype="float32"):
    s, r, w = _edges(symmetric)
    jd, td = DTYPES[tile_dtype]
    jh = jbcsr.build_hybrid(s, r, N, w, min_edges_per_tile=FILL,
                            symmetric=symmetric, dtype=jd)
    th = tbcsr.build_hybrid(s, r, N, w, min_edges_per_tile=FILL,
                            symmetric=symmetric, dtype=td, device="cpu")
    assert int(th.bcsr.tile_cnt[EMPTY_BLOCK]) == 0 and th.bcsr.n_tiles >= 4
    assert th.rem.n_edges > 0 and th.symmetric == symmetric
    return jh, th


def _operand(f, dtype, seed):
    a = np.random.default_rng(seed).normal(size=(N, f)).astype(np.float32)
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(td)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("f", [1, 7, 36])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("tile_dtype", sorted(DTYPES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bcsr_spmm_forward_and_dx_match_jax(dtype, tile_dtype, symmetric, f):
    """Forward on the forward tiles and ``dx`` on the transpose tiles (the
    forward tiles themselves when symmetric); the tiles are rounded to x's
    type on both sides."""
    jh, th = _hybrids(symmetric, tile_dtype)
    jx, tx = _operand(f, dtype, 1)
    jg, tg = _operand(f, dtype, 2)
    jout, vjp = jax.vjp(lambda x: j_bcsr_spmm(jh.bcsr, x, jh.bcsr_t), jx)
    (jdx,) = vjp(jg)
    tx.requires_grad_(True)
    tout = t_bcsr_spmm(th.bcsr, tx, th.bcsr_t)
    tout.backward(tg)
    assert tout.dtype == tx.grad.dtype == DTYPES[dtype][1]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32), **tol)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jdx, np.float32),
                               **tol)
    # the empty row block comes out zero, and the plain version is the
    # wrapper's CPU path
    rows = slice(EMPTY_BLOCK * 128, (EMPTY_BLOCK + 1) * 128)
    assert not _np(k3.bcsr_spmm(th.bcsr, tx.detach()))[rows].any()
    torch.testing.assert_close(k3.bcsr_spmm_plain(th.bcsr, tx.detach()),
                               tout.detach(), rtol=0, atol=0)


def test_bcsr_spmm_vector_input_and_default_transpose():
    """A 1-D x gives a 1-D result; without ``bg_t`` the forward tiles drive
    the backward, as in JAX."""
    jh, th = _hybrids(True)
    jx, tx = _operand(1, "float32", 3)
    jout, vjp = jax.vjp(lambda x: j_bcsr_spmm(jh.bcsr, x), jx[:, 0])
    (jdx,) = vjp(jnp.ones_like(jout))
    xv = tx[:, 0].clone().requires_grad_(True)
    tout = t_bcsr_spmm(th.bcsr, xv)
    tout.sum().backward()
    assert tout.shape == (N,) and xv.grad.shape == (N,)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **F32_TOL)
    np.testing.assert_allclose(_np(xv.grad), np.asarray(jdx), **F32_TOL)


@pytest.mark.parametrize("symmetric", [False, True])
def test_hybrid_spmm_matches_jax_and_coo(symmetric):
    """``spmm`` on a ``HybridGraph`` (tiles + remainder) against JAX's, and
    against the port's COO ``spmm`` over the same weighted edges."""
    jh, th = _hybrids(symmetric)
    s, r, w = _edges(symmetric)
    coo = tgraph.build_graph(s, r, N, w, device="cpu")
    jx, tx = _operand(36, "float32", 4)
    jg, tg = _operand(36, "float32", 5)
    jout, vjp = jax.vjp(lambda x: j_spmm(jh, x), jx)
    (jdx,) = vjp(jg)
    grads = []
    outs = []
    for graph in (th, coo):
        x = tx.clone().requires_grad_(True)
        out = t_spmm(graph, x)
        out.backward(tg)
        outs.append(_np(out))
        grads.append(_np(x.grad))
    for out, dx in zip(outs, grads):
        np.testing.assert_allclose(out, np.asarray(jout), **F32_TOL)
        np.testing.assert_allclose(dx, np.asarray(jdx), **F32_TOL)


@pytest.mark.parametrize("symmetric", [False, True])
def test_bcsr_neighbor_max_matches_jax_exactly(symmetric):
    """K7's plain version over the tiles' edge list: NEG where a row has
    no tiled in-edge, exact elsewhere."""
    jh, th = _hybrids(symmetric)
    jv, tv = _operand(32, "float32", 6)
    jout = np.asarray(jatt.bcsr_neighbor_max(jh.bcsr, jv))
    tout = tatt.bcsr_neighbor_max(th.bcsr, tv).numpy()
    empty = jout < NEG / 2
    assert empty.any() and not empty.all()
    np.testing.assert_array_equal(tout[~empty], jout[~empty])
    assert (tout[empty] == NEG).all()
    torch.testing.assert_close(k7.neighbor_max(th.bcsr, tv),
                               k7.neighbor_max_plain(th.bcsr, tv),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("symmetric", [False, True])
def test_hybrid_segment_max_forward_exact(symmetric, dtype):
    """Tiles (K7, NEG = -1e30) and remainder (K2, EMPTY = -3e38) combined:
    exact against JAX, and rows without in-edges map to 0."""
    jh, th = _hybrids(symmetric)
    jx, tx = _operand(32, dtype, 7)
    jout = np.asarray(jatt.hybrid_segment_max(jh, jx), np.float32)
    tout = tatt.hybrid_segment_max(th, tx)
    assert tout.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(tout), jout)
    has_in = np.bincount(_edges(symmetric)[1], minlength=N) > 0
    assert not has_in[ISOLATED].any()
    assert not _np(tout)[~has_in].any() and _np(tout)[has_in].any()
    np.testing.assert_array_equal(
        _np(tatt.hybrid_segment_max(th, tx, empty_value=-7.0))[ISOLATED],
        -7.0)


@pytest.mark.parametrize("symmetric", [False, True])
def test_hybrid_segment_max_grads_match_jax(symmetric):
    """Continuous random inputs hold no ties, so each cotangent goes to
    the one attaining neighbour in both packages."""
    jh, th = _hybrids(symmetric)
    jx, tx = _operand(32, "float32", 8)
    jc, tc = _operand(32, "float32", 9)
    jdx = jax.grad(lambda x: jnp.sum(jatt.hybrid_segment_max(jh, x) * jc))(
        jx)
    x = tx.clone().requires_grad_(True)
    (tatt.hybrid_segment_max(th, x) * tc).sum().backward()
    np.testing.assert_allclose(_np(x.grad), np.asarray(jdx), **F32_TOL)
    assert not _np(x.grad)[np.abs(np.asarray(jdx)) == 0].any()


def test_hybrid_segment_max_splits_ties_evenly():
    """A tie (two senders with the same value into one receiver) splits
    the cotangent evenly: the port's deliberate difference from JAX's
    nested ``max`` VJPs (ROADMAP queue 3)."""
    _, th = _hybrids(False)
    e = th.rem.n_edges
    recv, send = th.rem.receivers[:e], th.rem.senders[:e]
    r0 = next(int(r) for r in recv.unique()
              if len(send[recv == r].unique()) >= 2)
    senders = send[recv == r0].unique()
    x = torch.zeros(N, 1)
    x[senders[:2]] = 5.0
    x.requires_grad_(True)
    out = tatt.hybrid_segment_max(th, x)
    g = torch.zeros(N, 1)
    g[r0] = 1.0
    out.backward(g)
    assert float(out[r0]) == 5.0
    np.testing.assert_array_equal(_np(x.grad)[senders[:2].numpy(), 0],
                                  [0.5, 0.5])


@pytest.mark.parametrize("fn", ["bcsr_spmm", "neighbor_max"])
def test_kernel_wrappers_raise_off_cpu_and_cuda(fn):
    """No fallback: a tensor on neither the CPU nor a card raises."""
    _, th = _hybrids(True)
    x = torch.empty(N, 8, device="meta")
    wrapper = k3.bcsr_spmm if fn == "bcsr_spmm" else k7.neighbor_max
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(th.bcsr, x)
