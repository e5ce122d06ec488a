"""K1's gathered mean on the card past 32-bit products: graphs whose edges
times columns exceed 2**31 (``aggregate_mean``, forward and its backward
over the transpose), against a plain sum over blocks of edges. K1 forms
every address from an edge's table row or output row times the width in
64 bits; a 32-bit product of an edge id and a width would wrap here. The
CPU has no kernel: these skip there. Run on the card with ``python -m
pytest --noconftest tests/test_torch_k1_large.py -m card``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graphneuralnetwork_tpu_torch.core.graph import build_graph  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import aggregate  # noqa: E402

#: edges gathered at a time by the plain sum
BLOCK = 1 << 22


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain(x, src, dst, w, n):
    """``out[d] = Σ w · x[s]`` over the edges ``s -> d``, in blocks, float64
    sums of float32 products."""
    out = torch.zeros(n, x.shape[1], dtype=torch.float64, device=x.device)
    for lo in range(0, src.shape[0], BLOCK):
        hi = lo + BLOCK
        out.index_add_(0, dst[lo:hi], (x[src[lo:hi]] * w[lo:hi, None])
                       .double())
    return out


@pytest.mark.card
@pytest.mark.parametrize("cols", [256, 47])
def test_gathered_mean_past_32_bit_products(cols, card):
    """~1.1 x 2**31 / ``cols`` edges over 1,000,000 nodes, node 0 taking
    50,000 of them (a CTA of its own, forward and transposed); 256 columns
    take two 16-byte vectors a lane, 47 scalars over two slabs."""
    n = 1_000_000
    e = int(1.1 * 2 ** 31 / cols)
    assert e * cols > 2 ** 31
    rng = np.random.default_rng(cols)
    s = rng.integers(0, n, e, dtype=np.int64)
    r = rng.integers(0, n, e, dtype=np.int64)
    r[:50_000] = 0
    s[50_000:100_000] = 0
    g = build_graph(s.astype(np.int32), r.astype(np.int32), n, device=card)
    assert g.n_edges * cols > 2 ** 31
    x = torch.randn(n, cols, device=card, requires_grad=True)
    out = aggregate.aggregate_mean(g, x)
    grad = torch.randn(n, cols, device=card)
    out.backward(grad)
    src, dst = g.senders[:e].long(), g.receivers[:e].long()
    w = g.mean_weights[:e]
    xd = x.detach()
    with torch.no_grad():
        for got, table, a, b in ((out, xd, src, dst),
                                 (x.grad, grad, dst, src)):
            err = (got.double() - _plain(table, a, b, w, n)).abs()
            # float32 sums of up to 50,000 terms: within a few ulps of the
            # sum of |terms|
            bound = 1e-5 * _plain(table.abs(), a, b, w, n) + 1e-6
            assert bool((err <= bound).all()), float(err.max())
