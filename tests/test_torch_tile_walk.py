"""The host-side work split of K3 and K7 (``ops/cuda/tile_walk.py``).

The kernels run only on the card; what decides their launch runs here:
``tile_grid`` (rows per work item, column slab, item count),
``smem_bytes`` and ``copy_bytes`` (how ``x``'s rows are copied), and the
per-graph masks that the walk reads (``BCSRGraph.row_masks`` and
``col_masks``). Pinned: the grids at the path's shapes (the table in
PERF.md), the rule itself over many widths, the copy chunk against a numpy
computation of the largest power of two up to 16 that divides both a row's
bytes and the address, and the masks against numpy on the JAX package's
tiles.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import tile_walk  # noqa: E402

SMS = 132   # an H100 SXM


@pytest.mark.parametrize("n_rb, width, tile_size, mma, want", [
    (22, 128, 4, False, (64, 64, 88)),      # Cora GCN, f32 x
    (22, 7, 4, False, (64, 8, 44)),
    (22, 128, 4, True, (64, 64, 88)),       # Cora GCN, bf16 x
    (22, 7, 4, True, (64, 16, 44)),
    (22, 8, 4, False, (64, 8, 44)),         # Cora F=8, f32 x
    (22, 8, 0, False, (64, 8, 44)),         # Cora GAT, K7 at 8 heads
    (16, 500, 4, False, (64, 128, 128)),    # Pubmed SAGE
    (16, 128, 4, False, (64, 32, 128)),
    (16, 1, 4, False, (64, 4, 32)),
    (16, 500, 4, True, (64, 128, 128)),
    (16, 500, 0, False, (64, 128, 128)),    # K7 at Pubmed
    (16, 128, 0, False, (64, 32, 128)),
    (1024, 128, 4, False, (128, 64, 2048)),  # 2M-edge graph, f32 tiles
    (1024, 128, 2, False, (128, 128, 1024)),  # bf16 tiles
    (1024, 128, 4, True, (128, 128, 1024)),
    (1024, 128, 2, True, (128, 128, 1024)),
    (1024, 8, 2, False, (128, 8, 1024)),
    (1024, 128, 0, False, (128, 128, 1024)),  # K7: no tile values staged
    (1024, 8, 0, False, (128, 8, 1024)),
])
def test_tile_grid_at_path_shapes(n_rb, width, tile_size, mma, want):
    assert tile_walk.tile_grid(n_rb, width, SMS, tile_size, mma) == want


@pytest.mark.parametrize("mma", [False, True])
@pytest.mark.parametrize("tile_size", [2, 4])
def test_tile_grid_rule(tile_size, mma):
    """The slab fits two stages in shared memory and covers the width
    unless capped; halves only where whole blocks leave SMs idle; a slab
    narrower than that (not below 32) only where halves leave SMs idle and
    the items still fit on the SMs at once."""
    _check_rule(tile_size, mma)


def test_tile_grid_rule_without_tile_values():
    """The same rule for K7, which stages no tile values (size 0): every
    slab up to 128 fits, whole blocks or halves."""
    _check_rule(0, False)
    for rows in tile_walk.ROWS:
        assert tile_walk.smem_bytes(rows, 128, 0, False) <= tile_walk.MAX_SMEM
    assert (tile_walk.smem_bytes(128, 128, 0, False)
            < tile_walk.smem_bytes(128, 128, 2, False))


def _check_rule(tile_size, mma):
    for n_rb in (1, 5, 16, 22, 66, 132, 1024):
        for width in (*range(1, 140), 255, 256, 500, 1000):
            rows, slab, items = tile_walk.tile_grid(n_rb, width, SMS,
                                                   tile_size, mma)
            assert tile_walk.smem_bytes(rows, slab, tile_size,
                                        mma) <= tile_walk.MAX_SMEM
            fitting = [s for s in tile_walk.SLABS
                       if tile_walk.smem_bytes(rows, s, tile_size, mma)
                       <= tile_walk.MAX_SMEM and (s >= 16 or not mma)]
            widest = min([s for s in fitting if s >= width]
                         or [max(fitting)])
            assert items == n_rb * (128 // rows) * -(-width // slab)
            if slab != widest:   # split further: halves left SMs idle
                assert rows == 64 and 32 <= slab < widest
                assert items <= SMS
            elif rows == 64 and slab > 32:   # no narrower slab fits at once
                assert n_rb * 2 * -(-width // (slab // 2)) > SMS
            whole = tile_walk.tile_grid(n_rb, width, 10 ** 9, tile_size,
                                        mma)
            assert whole[0] == 64   # no card has that many SMs
            if rows == 64:
                slab128 = tile_walk.slab_width(width, 128, tile_size, mma)
                assert n_rb * -(-width // slab128) < SMS


def test_tile_grid_on_jax_built_tiles():
    """The row blocks of a JAX-built hybrid (600 nodes: 5 row blocks) give
    halves at every width, and the narrowest slab (down to 32) whose items
    still fit on the SMs at once."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 600, 6000)
    r = np.minimum((s // 64) * 64 + rng.integers(0, 64, 6000), 599)
    jh = jbcsr.build_hybrid(s, r, 600, min_edges_per_tile=64)
    n_rb = int(np.asarray(jh.bcsr.tile_off).shape[0])
    assert n_rb == 5
    for width, want in ((1, 4), (7, 8), (128, 32), (500, 64)):
        rows, slab, items = tile_walk.tile_grid(n_rb, width, SMS, 4, False)
        assert (rows, slab) == (64, want)
        assert items == 10 * -(-width // slab) <= SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 2, 7, 8, 36, 128, 500])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_copy_bytes_against_numpy(dtype, width, offset):
    """A view that starts ``offset`` values into its buffer."""
    buf = torch.zeros(6 * width + offset, dtype=dtype)
    x = buf[offset:].view(6, width)
    row_bytes = width * x.element_size()
    want = int(np.gcd(np.gcd(row_bytes, x.data_ptr()), 16))
    got = tile_walk.copy_bytes(x)
    assert got == want and got >= x.element_size()


def _hybrids(tile_dtype):
    """The JAX package's tiles (as a float32 numpy array) and the port's
    ``BCSRGraph`` of the same 600-node graph, built in ``tile_dtype``."""
    import jax.numpy as jnp
    from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr
    rng = np.random.default_rng(1)
    s = rng.integers(0, 600, 6000)
    r = np.minimum((s // 64) * 64 + rng.integers(0, 64, 6000), 599)
    dtypes = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[tile_dtype]
    jh = jbcsr.build_hybrid(s, r, 600, min_edges_per_tile=64,
                            dtype=dtypes[0])
    th = tbcsr.build_hybrid(s, r, 600, min_edges_per_tile=64,
                            dtype=dtypes[1], device="cpu")
    return np.asarray(jh.bcsr.tiles.astype(jnp.float32)), th.bcsr


def _words(flags):
    """uint32 [..., 4] of boolean [..., 128]: bit j of word q for entry
    32 q + j, one bit at a time."""
    want = np.zeros(flags.shape[:-1] + (4,), np.uint32)
    for col in range(128):
        want[..., col // 32] |= flags[..., col].astype(np.uint32) << (col % 32)
    return want


@pytest.mark.parametrize("tile_dtype", ["float32", "bfloat16"])
def test_col_masks_against_numpy_on_jax_built_tiles(tile_dtype):
    """``BCSRGraph.col_masks``: per tile and 64-row half, bit j of word q
    says whether column 32 q + j holds a nonzero slot in some row of the
    half; computed here with numpy from the JAX package's tiles."""
    tiles, bg = _hybrids(tile_dtype)
    want = _words((tiles != 0).reshape(-1, 2, 64, 128).any(axis=2))
    got = bg.col_masks
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want != 0).any() and (want != 0xFFFFFFFF).any()


@pytest.mark.parametrize("tile_dtype", ["float32", "bfloat16"])
def test_row_masks_against_numpy_on_jax_built_tiles(tile_dtype):
    """``BCSRGraph.row_masks``, the masks the walk folds over: per tile row,
    bit j of word q says whether slot 32 q + j is nonzero; computed here
    with numpy from the JAX package's tiles. Words with bit 31 set (which
    int32 holds as negative) and both set and clear bits occur."""
    tiles, bg = _hybrids(tile_dtype)
    want = _words(tiles != 0)
    got = bg.row_masks
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want != 0).any() and (want == 0).any()
    assert (want >> 31 == 1).any()
    set_bits = np.unpackbits(want.view(np.uint8)).sum()
    assert 0 < set_bits == int((tiles != 0).sum())
