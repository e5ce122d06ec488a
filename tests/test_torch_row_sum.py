"""The port's column-sum probe (``ops/cuda/row_sum_kernel.py``,
``tools/bench_dma.py`` of the port) against the TPU kernels of the JAX
package's ``tools/bench_dma.py`` on the CPU.

The TPU kernels ``reduce_auto`` and ``reduce_manual`` run in Pallas
interpret mode at a small shape: the test loads the JAX tool from its file
and, through ``monkeypatch``, sets its shape globals (8-row chunks, 8
chunks, 64 rows) and replaces its ``pl`` by a namespace whose
``pallas_call`` is ``pallas_call(..., interpret=True)``; the file is not
edited. Tolerance: every sum here is a float32 sum of M terms in some
order, so each lies within γ(M)·Σ|x| of the exact sum (the float32
summation bound, ``sum_tolerance``), and two of them within twice that.

The kernels' launch arithmetic (blocks, grids, ring layouts, the chains of
additions behind the tolerance, the shapes that raise) is pure Python and
is pinned here; the kernels themselves run only on the card
(``chip_smoke.py``'s ``row_sum`` phase).
"""

import functools
import importlib.util
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.experimental import pallas as pl  # noqa: E402

from graphneuralnetwork_tpu_torch.ops.cuda import row_sum_kernel as rs  # noqa: E402
from graphneuralnetwork_tpu_torch.tools import bench_dma  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHUNK, N_CHUNKS = 8, 8
M, F = CHUNK * N_CHUNKS, 128


@pytest.fixture
def tpu_tool(monkeypatch):
    """The JAX package's ``tools/bench_dma.py`` at [64, 128], its Pallas
    calls in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_bench_dma", ROOT / "tools" / "bench_dma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(mod, "pl", interp)
    monkeypatch.setattr(mod, "CHUNK", CHUNK)
    monkeypatch.setattr(mod, "N_CHUNKS", N_CHUNKS)
    monkeypatch.setattr(mod, "M", M)
    return mod


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(M, F)).astype(np.float32)


def _tol(x, factor=2.0):
    """factor · γ(M) · Σ|x| per column (float64)."""
    abs_sum = torch.from_numpy(np.abs(x).astype(np.float64).sum(0))
    return factor * rs.sum_tolerance(x.shape[0], abs_sum).numpy()


@pytest.mark.parametrize("variant", ["auto", "manual_2", "manual_4",
                                     "manual_8", "xla"])
def test_plain_row_sum_matches_tpu_kernels(tpu_tool, x, variant):
    fn = {"auto": tpu_tool.reduce_auto, "xla": tpu_tool.reduce_xla}.get(
        variant) or functools.partial(tpu_tool.reduce_manual,
                                      n_buffers=int(variant.split("_")[1]))
    want = np.asarray(jax.block_until_ready(fn(jnp.asarray(x))))
    got = rs.row_sum_plain(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (8, F)
    assert got.dtype == want.dtype == np.float32
    assert (np.abs(got - want) <= _tol(x)).all(), np.abs(got - want).max()
    # every output row holds the column sums, on both sides
    exact = x.astype(np.float64).sum(0)
    for out in (got, want):
        assert (np.abs(out - exact) <= _tol(x, 1.0)).all()


@pytest.mark.parametrize("call", [
    rs.row_sum_stream,
    functools.partial(rs.row_sum_ring, n_slots=2),
    functools.partial(rs.row_sum_ring, n_slots=4),
    functools.partial(rs.row_sum_ring, n_slots=8),
])
def test_cpu_tensors_take_the_plain_version(x, call):
    before = (rs.row_sum_stream.launches, rs.row_sum_ring.launches)
    xt = torch.from_numpy(x)
    assert torch.equal(call(xt), rs.row_sum_plain(xt))
    assert (rs.row_sum_stream.launches, rs.row_sum_ring.launches) == before


def test_ring_rejects_other_slot_counts(x):
    with pytest.raises(ValueError, match="n_slots"):
        rs.row_sum_ring(torch.from_numpy(x), n_slots=3)
    with pytest.raises(ValueError, match="n_slots"):
        rs.ring_layout(M, F, 16, 132)


def test_other_devices_raise(x):
    meta = torch.empty(M, F, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rs.row_sum_stream(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.row_sum_ring(meta, 4)


@pytest.mark.parametrize("f", [3, 0, 6, 1028, 2048])
def test_unsupported_widths_raise(f):
    with pytest.raises(ValueError, match="width"):
        rs.block_shape(f)
    with pytest.raises(ValueError, match="width"):
        rs.stream_grid(64, f, 132)
    with pytest.raises(ValueError, match="width"):
        rs.ring_layout(64, f, 2, 132)


@pytest.mark.parametrize("m", [0, 2 ** 24])
def test_unsupported_row_counts_raise(m):
    with pytest.raises(ValueError, match="rows"):
        rs.stream_grid(m, 128, 132)
    with pytest.raises(ValueError, match="rows"):
        rs.ring_layout(m, 128, 4, 132)


@pytest.mark.parametrize("f,lanes,rows", [(4, 1, 256), (12, 3, 85),
                                          (128, 32, 8), (500, 125, 2),
                                          (1024, 256, 1)])
def test_block_shape(f, lanes, rows):
    assert rs.block_shape(f) == (lanes, rows)
    assert lanes * rows <= rs.THREADS


@pytest.mark.parametrize("m,f,sms", [(2_097_152, 128, 132), (48, 128, 132),
                                     (4096, 128, 132), (1000, 12, 132),
                                     (777, 1024, 132), (100_003, 500, 114)])
def test_stream_grid_covers_every_row_once(m, f, sms):
    n_ctas, per_cta = rs.stream_grid(m, f, sms)
    _, rows_step = rs.block_shape(f)
    assert per_cta % (rows_step * rs.UNROLL) == 0
    # contiguous ranges, none empty, the last one ending at m or past it
    assert per_cta * (n_ctas - 1) < m <= per_cta * n_ctas
    assert n_ctas <= rs.STREAM_CTAS_PER_SM * sms


def test_stream_grid_at_the_tools_shape():
    # 1 GiB: 1,041 CTAs of 2,016 rows, ~7.9 an SM
    assert rs.stream_grid(2_097_152, 128, 132) == (1041, 2016)


@pytest.mark.parametrize("slots", rs.SLOTS)
@pytest.mark.parametrize("m,f,sms", [(2_097_152, 128, 132), (48, 128, 132),
                                     (1000, 12, 132), (777, 1024, 132),
                                     (100_003, 500, 114)])
def test_ring_layout(slots, m, f, sms):
    lay = rs.ring_layout(m, f, slots, sms)
    rows = lay["slot_rows"]
    # a slot holds whole rows within SLOT_BYTES, and a bulk copy of any
    # number of them is a multiple of 16 bytes
    assert rows == rs.SLOT_BYTES // (4 * f) and rows * f * 4 % 16 == 0
    # the C side's count: the barriers, then the slots
    assert lay["smem_bytes"] == rs.BAR_BYTES + slots * rows * f * 4
    assert lay["smem_bytes"] + rs.STATIC_SMEM <= rs.MAX_SMEM
    per_sm = lay["ctas_per_sm"]
    assert per_sm in (1, 2)
    resident = (lay["smem_bytes"] + rs.STATIC_SMEM + rs.CTA_RESERVED)
    assert per_sm * resident <= rs.SM_SMEM
    assert (per_sm == 1) == (2 * resident > rs.SM_SMEM)
    n_chunks = math.ceil(m / rows)
    per_cta, n_ctas = lay["chunks_per_cta"], lay["n_ctas"]
    assert per_cta * (n_ctas - 1) < n_chunks <= per_cta * n_ctas
    assert n_ctas <= per_sm * sms


def test_ring_layout_at_the_tools_shape():
    # 32-row (16 KiB) slots; two rings an SM at 2 and 4 slots, one at 8
    lays = [rs.ring_layout(2_097_152, 128, s, 132) for s in rs.SLOTS]
    assert [(l["smem_bytes"], l["ctas_per_sm"], l["n_ctas"],
             l["chunks_per_cta"]) for l in lays] == [
        (32896, 2, 264, 249), (65664, 2, 264, 249), (131200, 1, 132, 497)]


def test_chain_lengths():
    """Each value's additions: its thread's running sum, the fold of the
    thread's accumulators and of the CTA's rows, and the ordered pass over
    the partial rows."""
    n_ctas, per_cta = rs.stream_grid(2_097_152, 128, 132)
    assert rs.chain_length("stream", 2_097_152, 128, 132) == (
        per_cta // 8 + rs.UNROLL - 1 + 8 - 1 + n_ctas - 1)
    lay = rs.ring_layout(2_097_152, 128, 8, 132)
    assert rs.chain_length("ring", 2_097_152, 128, 132, 8) == (
        lay["chunks_per_cta"] * 4 + 1 + 8 - 1 + lay["n_ctas"] - 1)
    with pytest.raises(ValueError, match="unknown"):
        rs.chain_length("tree", 64, 128, 132)


def test_sum_tolerance_is_gamma_times_abs_sum():
    abs_sum = torch.tensor([1.0, 1e6], dtype=torch.float64)
    k = 1000
    gamma = k * 2.0 ** -24 / (1 - k * 2.0 ** -24)
    assert torch.allclose(rs.sum_tolerance(k, abs_sum), gamma * abs_sum,
                          rtol=1e-15, atol=0)


def test_tolerance_holds_a_float32_sequential_sum():
    """The bound is met by the worst order, a left-to-right float32 sum."""
    x = np.random.default_rng(3).normal(size=(4096, 4)).astype(np.float32)
    seq = np.zeros(4, np.float32)
    for row in x:
        seq = seq + row
    exact = x.astype(np.float64).sum(0)
    tol = rs.sum_tolerance(4096, torch.from_numpy(
        np.abs(x).astype(np.float64).sum(0))).numpy()
    assert (np.abs(seq - exact) <= tol).all()


def test_bench_dma_tool_on_the_cpu(capsys):
    res = bench_dma.main(["--rows", "96", "--width", "64", "--device", "cpu"])
    assert res["device"] == "cpu" and res["bytes"] == (96 + 8) * 64 * 4
    assert res["bound_ms"] == pytest.approx(
        res["bytes"] / bench_dma.PEAK_BYTES_PER_S * 1e3)
    assert list(res["variants"]) == ["plain", "stream", "ring_x2", "ring_x4",
                                     "ring_x8"]
    for entry in res["variants"].values():
        assert "ms" not in entry        # no device time on the CPU
        assert entry["chain"] == 96
    assert capsys.readouterr().out.strip().endswith("}")


def test_bench_dma_tool_rejects_a_width_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="width"):
        bench_dma.main(["--rows", "16", "--width", "6", "--device", "cpu"])


def test_bench_dma_check_catches_a_lost_row():
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(256, 8)).astype(np.float32))
    ref = x.sum(0, dtype=torch.float64)
    tol = rs.sum_tolerance(256, x.abs().sum(0, dtype=torch.float64))
    assert bench_dma.check("plain", rs.row_sum_plain(x), ref, tol) >= 0.0
    with pytest.raises(AssertionError, match="off the float64 sum"):
        bench_dma.check("lost", rs.row_sum_plain(x[1:]), ref, tol)
    bad_rows = rs.row_sum_plain(x).clone()
    bad_rows[3] += 1.0
    with pytest.raises(AssertionError, match="rows differ"):
        bench_dma.check("rows", bad_rows, ref, tol)
