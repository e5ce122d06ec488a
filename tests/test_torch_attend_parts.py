"""The three-pass hybrid GAT attend of the PyTorch port against the JAX
package.

The plain versions of K8 (``rem_attend_plain``), K9 (``tile_parts_plain``)
and K10 (``attend_fused_plain``) against the TPU kernels run in interpret
mode (``_rem_parts_impl``, ``_tile_parts_impl`` and ``_fused_impl`` under
``set_ops_impl("pallas")``) and against the XLA formulation
(``_rem_parts_xla``, ``_parts_xla``), in float32 and bfloat16, with and
without the JAX-drawn dropout masks, with the exact shift and with the
profiler's stand-in ``m = 0`` (where the exponent's clamp at 0 bites); the
autograd functions against ``jax.vjp`` of the JAX ones;
``gat_tiled_attend_parts`` against JAX's ``gat_tiled_attend`` on the CPU
(its three-pass route) and against the port's K4-K6 route; the stage
profiler on the CPU.

Tolerances:
  * float32: the JAX package's own for its attend kernels against its XLA
    path (``tests/test_attend_online_kernel.py``), forward ``rtol=2e-4,
    atol=2e-5`` and gradients ``rtol=5e-4, atol=5e-5``: both sides sum in
    float32 in other orders;
  * bfloat16: both sides relative to the reference's largest entry, at
    ``rtol=atol=2e-2``, the tolerance of
    ``tests/test_torch_attend.py::test_gat_on_hybrid_matches_flax``: the
    TPU kernels and the XLA path round the softmax weight ``p`` to bfloat16
    before the product with ``x``, the port multiplies in float32 (ROADMAP
    queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from graphneuralnetwork_tpu.core import bcsr as jbcsr  # noqa: E402
from graphneuralnetwork_tpu.ops import bcsr_attention as jatt  # noqa: E402
from graphneuralnetwork_tpu.ops import set_ops_impl  # noqa: E402
from graphneuralnetwork_tpu_torch.core import bcsr as tbcsr  # noqa: E402
from graphneuralnetwork_tpu_torch.ops import bcsr_attention as tatt  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import (  # noqa: E402
    attend_parts_kernel as k910, rem_attend_kernel as k8)
from graphneuralnetwork_tpu_torch.ops.cuda.counters import (  # noqa: E402
    read_launches)
from graphneuralnetwork_tpu_torch.tools import profile_attend  # noqa: E402

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
BWD_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SLOPE, KEEP = 0.2, 0.6
N, HEADS, FEAT = 400, 2, 8
#: rows of the last row block (384..399) get remainder edges only
NO_TILE_ROWS = slice(384, 400)


@pytest.fixture(scope="module")
def graphs():
    """Both packages' hybrid of a community graph on nodes 0..299 (~90 %
    of the edges inside blocks of 64) plus 60 scattered edges into nodes
    300..399: tiles where the communities are, a remainder, a row block
    without tiles and nodes without in-edges."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, 300, 3000)
    intra = rng.random(3000) < 0.9
    r = np.where(intra, np.minimum((s // 64) * 64 + rng.integers(0, 64, 3000),
                                   299), rng.integers(0, 300, 3000))
    s = np.concatenate([s, rng.integers(0, N, 60)])
    r = np.concatenate([r, rng.integers(300, N, 60)])
    keep = s != r
    s, r = s[keep].astype(np.int32), r[keep].astype(np.int32)
    jh = jbcsr.build_hybrid(s, r, N, min_edges_per_tile=48)
    th = tbcsr.build_hybrid(s, r, N, min_edges_per_tile=48, device="cpu")
    assert th.bcsr.n_tiles >= 4 and th.rem.n_edges > 100
    assert int(th.bcsr.tile_cnt[NO_TILE_ROWS.start // 128]) == 0
    return jh, th


def _operands(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, HEADS, FEAT)).astype(np.float32),
            rng.normal(size=(N, HEADS)).astype(np.float32),
            rng.normal(size=(N, HEADS)).astype(np.float32))


def _jax_masks(jh, seed):
    """The masks JAX's ``gat_tiled_attend`` draws from ``dropout_rng``:
    the uint32 lattice and the remainder multiplier, as numpy."""
    rng = jax.random.PRNGKey(seed)
    bits = jax.random.bits(jax.random.fold_in(rng, 0),
                           (jh.bcsr.tiles.shape[0], 128, 128), jnp.uint32)
    keep = jax.random.bernoulli(jax.random.fold_in(rng, 1), KEEP,
                                (jh.rem.senders.shape[0], HEADS))
    return rng, np.asarray(bits), np.asarray(keep.astype(jnp.float32) / KEEP)


def _t(a):
    a = np.array(a)   # a writable copy of a JAX array
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _jax_shift(jh, fs, fd):
    """JAX's three-pass shift (``gat_tiled_attend``'s off-TPU route)."""
    rem = jh.rem
    fs, fd = jnp.asarray(fs), jnp.asarray(fd)
    nmax = jnp.maximum(
        jatt.bcsr_neighbor_max(jh.bcsr, fs),
        jatt._rem_segment_max(rem, jnp.where(rem.edge_mask[:, None],
                                             fs[rem.senders], jatt.NEG)))
    return np.asarray(jnp.where(nmax > jatt.NEG / 2,
                                jatt._leaky(fd + nmax, SLOPE), 0.0))


def _tpu_kernel(fn, *args):
    """``fn(*args)`` on the JAX package's Pallas branch, run in TPU
    interpret mode, and waited for: the interpreter's callbacks dispatch
    JAX operations of their own, and one dispatched meanwhile from this
    thread can deadlock with them."""
    set_ops_impl("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            return jax.block_until_ready(fn(*args))
    finally:
        set_ops_impl("auto")


def _case(graphs, dtype, dropout, shift, seed):
    """Operands of one kernel case for both packages: (jax dict, port
    dict, port hybrid); bfloat16 puts ``x`` (and the port's tiles, whose
    counts bfloat16 holds exactly) in bfloat16."""
    jh, th = graphs
    x, fs, fd = _operands(seed)
    m = _jax_shift(jh, fs, fd) if shift == "exact" else np.zeros_like(fs)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        th = dataclasses.replace(th, bcsr=dataclasses.replace(
            th.bcsr, tiles=th.bcsr.tiles.to(torch.bfloat16)))
    if dropout:
        _, bits, keep_mul = _jax_masks(jh, seed + 100)
    else:
        bits = np.zeros((jh.bcsr.tiles.shape[0], 1, 1), np.uint32)
        keep_mul = None
    kp = KEEP if dropout else 1.0
    j = dict(x=jnp.asarray(x, jdt), fs=jnp.asarray(fs), fd=jnp.asarray(fd),
             m=jnp.asarray(m), bits=jnp.asarray(bits),
             keep_mul=None if keep_mul is None else jnp.asarray(keep_mul),
             kp=kp)
    t = dict(x=torch.from_numpy(x).to(tdt).reshape(N, -1), fs=_t(fs),
             fd=_t(fd), m=_t(m), bits=_t(bits) if dropout else None,
             keep_mul=None if keep_mul is None else _t(keep_mul), kp=kp)
    return j, t, th


def _close(got, want, dtype, err_msg=""):
    got = np.asarray(got, np.float32).reshape(np.shape(want))
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=err_msg, **FWD_TOL)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got / scale, want / scale,
                                   err_msg=err_msg, **BF16_TOL)


CASES = [(dtype, dropout, shift) for dtype in ("float32", "bfloat16")
         for dropout in (False, True) for shift in ("exact", "zero")]


@pytest.mark.parametrize("dtype,dropout,shift", CASES)
def test_rem_attend_plain_matches_tpu_kernel(graphs, dtype, dropout, shift):
    """K8's plain version against ``_rem_attend_kernel`` (interpret mode)
    and ``_rem_parts_xla`` on the same operands."""
    j, t, th = _case(graphs, dtype, dropout, shift, seed=1)
    rem = graphs[0].rem
    args = (rem, j["x"], j["fs"], j["fd"], j["m"], j["keep_mul"], SLOPE)
    k_num, k_den = _tpu_kernel(jatt._rem_parts_impl, *args)
    x_num, x_den = jatt._rem_parts_xla(*args)
    num, den = k8.rem_attend(th, t["x"], t["fs"], t["fd"], t["m"],
                             t["keep_mul"], SLOPE)
    assert num.dtype == den.dtype == torch.float32
    assert num.shape == (N, HEADS * FEAT) and den.shape == (N, HEADS)
    for ref_num, ref_den, what in ((k_num, k_den, "kernel"),
                                   (x_num, x_den, "xla")):
        _close(num.numpy(), ref_num, dtype, f"num vs {what}")
        _close(den.numpy(), ref_den, "float32", f"den vs {what}")
    assert k8.rem_attend.launches == 0   # the CPU takes the plain version


@pytest.mark.parametrize("dtype,dropout,shift", CASES)
def test_tile_parts_plain_matches_tpu_kernel(graphs, dtype, dropout, shift):
    """K9's plain version against ``_attend_kernel`` (interpret mode) and
    ``_parts_xla``; rows without tile slots get zeros."""
    j, t, th = _case(graphs, dtype, dropout, shift, seed=2)
    bg = graphs[0].bcsr
    args = (bg, j["bits"], j["x"], j["fs"], j["fd"], j["m"], SLOPE, j["kp"])
    k_num, k_den = _tpu_kernel(jatt._tile_parts_impl, *args)
    x_num, x_den = jatt._parts_xla(*args)
    num, den = k910.tile_parts(th, t["x"], t["fs"], t["fd"], t["m"],
                               t["bits"], SLOPE, t["kp"])
    assert num.dtype == den.dtype == torch.float32
    for ref_num, ref_den, what in ((k_num, k_den, "kernel"),
                                   (x_num, x_den, "xla")):
        _close(num.numpy(), ref_num, dtype, f"num vs {what}")
        _close(den.numpy(), ref_den, "float32", f"den vs {what}")
    assert not num[NO_TILE_ROWS].any() and not den[NO_TILE_ROWS].any()
    assert k910.tile_parts.launches == 0


@pytest.mark.parametrize("dtype,dropout,shift", CASES)
def test_attend_fused_plain_matches_tpu_kernel(graphs, dtype, dropout,
                                               shift):
    """K10's plain version against ``_attend_fused_kernel`` (interpret
    mode) and the XLA composition, seeded with the remainder's partials:
    the divided output and the raw mass; a row whose block has no tile
    gets ``num_init / max(den_init, 1e-16)``."""
    j, t, th = _case(graphs, dtype, dropout, shift, seed=3)
    jh = graphs[0]
    r_num, r_den = jatt._rem_parts_xla(jh.rem, j["x"], j["fs"], j["fd"],
                                       j["m"], j["keep_mul"], SLOPE)
    args = (jh.bcsr, j["bits"], j["x"], j["fs"], j["fd"], j["m"], r_num,
            r_den, SLOPE, j["kp"])
    k_out, k_den = _tpu_kernel(jatt._fused_impl, *args)
    x_out, x_den = jatt._fused_impl(*args)   # off the TPU: XLA
    num_init, den_init = _t(r_num).reshape(N, -1), _t(r_den)
    out, den = k910.attend_fused(th, t["x"], t["fs"], t["fd"], t["m"],
                                 num_init, den_init, t["bits"], SLOPE,
                                 t["kp"])
    assert out.dtype == den.dtype == torch.float32
    for ref_out, ref_den, what in ((k_out, k_den, "kernel"),
                                   (x_out, x_den, "xla")):
        _close(out.numpy(), ref_out, dtype, f"out vs {what}")
        _close(den.numpy(), ref_den, "float32", f"den vs {what}")
    rows = NO_TILE_ROWS
    want = num_init[rows].view(-1, HEADS, FEAT) / torch.clamp_min(
        den_init[rows], 1e-16)[:, :, None]
    torch.testing.assert_close(out[rows], want.reshape(-1, HEADS * FEAT),
                               rtol=0, atol=0)
    torch.testing.assert_close(den[rows], den_init[rows], rtol=0, atol=0)
    assert k910.attend_fused.launches == 0


def _cotangents(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("fn", ["rem_parts", "tile_parts", "attend_fused"])
def test_autograd_functions_match_jax_vjp(graphs, fn, dropout):
    """The gradients of ``_RemParts``, ``_TileParts`` and ``_AttendFused``
    (the plain formulation, recomputed in chunks) against ``jax.vjp`` of
    JAX's ``_rem_parts``, ``_tile_parts`` and ``_attend_fused`` on random
    cotangents of both outputs; ``_AttendFused`` also passes gradients to
    its seeds."""
    j, t, th = _case(graphs, "float32", dropout, "exact", seed=4)
    jh = graphs[0]
    g_a, g_b = _cotangents(9, [(N, HEADS, FEAT), (N, HEADS)])
    seeds_j = jatt._rem_parts_xla(jh.rem, j["x"], j["fs"], j["fd"], j["m"],
                                  j["keep_mul"], SLOPE)
    ins_j = [j["x"], j["fs"], j["fd"]]
    ins_t = [t["x"].clone().requires_grad_(), t["fs"].clone().requires_grad_(),
             t["fd"].clone().requires_grad_()]
    if fn == "rem_parts":
        _, vjp = jax.vjp(lambda a, b, c: jatt._rem_parts(
            jh.rem, a, b, c, j["m"], j["keep_mul"], SLOPE), *ins_j)
        outs = tatt._RemParts.apply(*ins_t, t["m"], th, t["keep_mul"], SLOPE)
    elif fn == "tile_parts":
        _, vjp = jax.vjp(lambda a, b, c: jatt._tile_parts(
            jh.bcsr, j["bits"], a, b, c, j["m"], SLOPE, j["kp"]), *ins_j)
        outs = tatt._TileParts.apply(*ins_t, t["m"], th, t["bits"], SLOPE,
                                     t["kp"])
    else:
        ins_j += list(seeds_j)
        _, vjp = jax.vjp(lambda a, b, c, d, e: jatt._attend_fused(
            jh.bcsr, j["bits"], a, b, c, j["m"], d, e, SLOPE, j["kp"]),
            *ins_j)
        ins_t += [_t(seeds_j[0]).reshape(N, -1).requires_grad_(),
                  _t(seeds_j[1]).requires_grad_()]
        outs = tatt._AttendFused.apply(*ins_t[:3], t["m"], *ins_t[3:], th,
                                       t["bits"], SLOPE, t["kp"])
    refs = vjp((jnp.asarray(g_a), jnp.asarray(g_b)))
    (outs[0] * _t(g_a).reshape(N, -1)).sum().add(
        (outs[1] * _t(g_b)).sum()).backward()
    names = ["dx", "dfs", "dfd", "d num_init", "d den_init"]
    for name, t_in, ref in zip(names, ins_t, refs):
        np.testing.assert_allclose(
            t_in.grad.numpy().reshape(np.shape(ref)), np.asarray(ref),
            err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_pass_matches_jax_gat_tiled_attend(graphs, dtype, dropout):
    """``gat_tiled_attend_parts`` against JAX's ``gat_tiled_attend`` on the
    CPU, which takes the same three-pass route: the output and the
    gradients of x, f_src and f_dst, with the JAX-drawn masks."""
    jh, th = graphs
    x, fs, fd = _operands(6)
    g = _cotangents(10, [x.shape])[0]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    kw_j, kw_t = {}, {}
    if dropout:
        rng, bits, keep_mul = _jax_masks(jh, 23)
        kw_j = dict(attn_dropout=1 - KEEP, dropout_rng=rng)
        kw_t = dict(attn_dropout=1 - KEEP, bits=_t(bits),
                    keep_mul=_t(keep_mul))

    def loss(a, b, c):
        out = jatt.gat_tiled_attend(jh, a, b, c, **kw_j)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, ref), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(fs), jnp.asarray(fd))
    ins = [torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(),
           _t(fs).requires_grad_(), _t(fd).requires_grad_()]
    out = tatt.gat_tiled_attend_parts(th, *ins, **kw_t)
    assert out.dtype == ins[0].dtype and torch.isfinite(out.float()).all()
    (out.float() * _t(g)).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **FWD_TOL)
        for name, t_in, r in zip(("dx", "dfs", "dfd"), ins, grads):
            np.testing.assert_allclose(t_in.grad.numpy(), np.asarray(r),
                                       err_msg=name, **BWD_TOL)
        return
    # bfloat16: the gradients against their common scale, as the model
    # test does; JAX's own bfloat16 d f_dst is ~2.5e-2 of its scale off
    # its float32 one (it rounds p before the products), the port's ~4e-3
    _close(out.detach().float().numpy(), np.asarray(ref, np.float32), dtype)
    gs = max(float(jnp.abs(r).max()) for r in grads)
    for name, t_in, r in zip(("dx", "dfs", "dfd"), ins, grads):
        np.testing.assert_allclose(t_in.grad.float().numpy() / gs,
                                   np.asarray(r, np.float32) / gs,
                                   err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("dropout", [False, True])
def test_three_pass_matches_port_online_attend(graphs, dropout):
    """The three-pass route and the port's K4-K6 route compute one
    function: equal outputs and gradients (float32)."""
    _, th = graphs
    x, fs, fd = _operands(7)
    g = _t(_cotangents(11, [x.shape])[0])
    kw = {}
    if dropout:
        bits, keep_mul = tatt.draw_dropout(th, HEADS, KEEP,
                                           torch.Generator().manual_seed(5))
        kw = dict(attn_dropout=1 - KEEP, bits=bits, keep_mul=keep_mul)
    res = []
    for fn in (tatt.gat_tiled_attend, tatt.gat_tiled_attend_parts):
        ins = [_t(a).requires_grad_() for a in (x, fs, fd)]
        out = fn(th, *ins, **kw)
        (out * g).sum().backward()
        res.append([out.detach()] + [a.grad for a in ins])
    tols = [FWD_TOL] + [BWD_TOL] * 3
    for name, a, b, tol in zip(("out", "dx", "dfs", "dfd"), *res, tols):
        np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=name, **tol)


def test_three_pass_shift(graphs):
    """``three_pass_shift`` equals JAX's: LeakyReLU of f_dst plus the
    neighbour max of f_src, 0 on nodes without in-edges."""
    jh, th = graphs
    _, fs, fd = _operands(8)
    m = tatt.three_pass_shift(th, _t(fs), _t(fd), SLOPE)
    np.testing.assert_array_equal(m.numpy(), _jax_shift(jh, fs, fd))
    empty = np.setdiff1d(np.arange(N), np.concatenate(
        [th.bcsr.slot_edges[0].numpy(), th.rem.receivers[:th.rem.n_edges]]))
    assert empty.size and not m[empty].any()


@pytest.mark.parametrize("wrapper", ["rem_attend", "tile_parts",
                                     "attend_fused"])
def test_wrappers_refuse_other_devices(graphs, wrapper):
    """A tensor neither on the CPU nor on the card is refused before any
    kernel is built."""
    _, th = graphs
    x = torch.empty(N, HEADS * FEAT, device="meta")
    v = torch.empty(N, HEADS, device="meta")
    calls = {
        "rem_attend": lambda: k8.rem_attend(th, x, v, v, v, None, SLOPE),
        "tile_parts": lambda: k910.tile_parts(th, x, v, v, v, None, SLOPE,
                                              1.0),
        "attend_fused": lambda: k910.attend_fused(th, x, v, v, v, x, v,
                                                  None, SLOPE, 1.0),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[wrapper]()


@pytest.mark.parametrize("argv", [[], ["--dtype", "float32", "--stages",
                                       "three_pass,full"]])
def test_profile_attend_on_cpu(argv):
    """The stage profiler at a tiny shape on the CPU: every requested stage
    is timed on the host clock only, no kernel launches, and the graph has
    tiles and a remainder."""
    res = profile_attend.main(["--device", "cpu", "--nodes", "600",
                               "--edges", "6000", "--comm", "64", "--heads",
                               "2", "--feat", "8", "--min-edges-per-tile",
                               "48"] + argv)
    want = (profile_attend.STAGES if not argv
            else ("three_pass", "full"))
    assert tuple(res["stages"]) == tuple(want)
    for entry in res["stages"].values():
        assert entry["ms"] is None and entry["cpu_ms"] > 0
        assert entry["launches"] == {}
    graph = res["graph"]
    assert graph["tiles"] > 0 and graph["rem_edges"] > 0
    assert graph["edges"] == graph["rem_edges"] + round(
        graph["tiled"] * graph["edges"])
    assert res["device"] == "cpu" and res["card"] is None
    assert not any(read_launches().values())
