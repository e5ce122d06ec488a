"""Full-batch HAN of the PyTorch port against the JAX package on the CPU:
``SemanticAttention`` (with and without a row mask) and ``HAN`` on the COO
and the hybrid metapath graphs, float32 and bfloat16, from the same flax
parameters (``params.from_flax``); the captured chunk (``HANBlock``) under
``test_torch_capture.StubGraph`` against eager epochs; and the ``han``
CLI, whose per-epoch losses follow JAX's ``cli.main`` from the same
initial parameters (no dropout on either side).

On the hybrid layout the port runs the plain versions of K4-K6 on the CPU;
JAX runs ``gat_tiled_attend`` as its own CPU tests do (its XLA path).

Tolerances, each against the largest entry of the output it holds, or for
a parameter's gradient the largest gradient entry of its module (a
Linear's weight and bias together), where the semantic attention's
projection and ``q`` count as one module: the projection bias's gradient
is a sum over P x N rows that cancels to ~1e-2 of its weight's:
float32 outputs ``F32_FWD`` = 2e-5, float32 gradients ``F32_GRAD`` = 1e-4
(both sides sum in float32 in other orders; a gradient's sums cancel);
bfloat16 ``BF16`` = 3e-2 for outputs and gradients. In bfloat16 the
logits are held against JAX's bfloat16 logits and the gradients against
JAX's float32 gradients, the values both bfloat16 runs approximate: JAX
rounds the hybrid attention's softmax weight ``p`` to bfloat16 and the
port does not, which moves JAX's own classifier bias gradient (a sum over
the training rows that cancels) by ~8e-2 of its scale from its float32
value, and the port's by ~1.4e-2. The CLI's losses ``LOSS_TOL`` = 1e-4
relative: float32 AdamW steps on gradients that differ by rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.data import acm as jacm  # noqa: E402
from graphneuralnetwork_tpu.nn import han as jhan  # noqa: E402
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.data import acm as tacm  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import han as than  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import counters  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import han_loop  # noqa: E402
from graphneuralnetwork_tpu_torch.train import scan_loop  # noqa: E402
from graphneuralnetwork_tpu_torch.train.loop import (  # noqa: E402
    create_train_state)
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as t_ce)
from graphneuralnetwork_tpu_torch.train.schedule import (  # noqa: E402
    make_optimizer)
from test_torch_capture import (  # noqa: E402, F401 (fixtures)
    StubGraph, counted, one_thread)

F32_FWD, F32_GRAD, BF16, LOSS_TOL = 2e-5, 1e-4, 3e-2, 1e-4


def _close(got, want, tol, what):
    """``|got - want| <= tol * max|want|``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} of scale {scale}"


def _scale_group(name):
    """A module's parameters (a Linear's weight and bias together); the
    semantic attention's projection shares ``q``'s group."""
    module = name.rpartition(".")[0]
    return module[:-len("proj")].rstrip(".") if module.endswith(
        "proj") else module


def _close_grads(got, want, tol):
    """Each parameter's gradient against its scale group's largest
    entry."""
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        scale = max(float(w.abs().max()) for k, w in want.items()
                    if _scale_group(k) == _scale_group(name))
        err = float((got[name].double() - g.double()).abs().max())
        assert err <= tol * scale, f"{name}: max err {err} of {scale}"


def _jax_params(tree):
    return from_flax(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def han_data():
    """The ACM loaders' output at 300 papers in both packages, COO and
    hybrid (the hybrid's PAP keeps a remainder)."""
    out = {}
    for layout in ("coo", "hybrid"):
        out[layout] = (jacm.load_acm_han(seed=0, layout=layout,
                                         n_papers=300),
                       tacm.load_acm_han(seed=0, layout=layout,
                                         n_papers=300, device="cpu"))
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_semantic_attention_matches_flax(masked):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 50, 12)).astype(np.float32)
    ct = rng.normal(size=(50, 12)).astype(np.float32)
    mask = np.arange(50) < 37 if masked else None
    jm = jhan.SemanticAttention(hidden=16)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(z))["params"]

    def jf(p, zz):
        out = jm.apply({"params": p}, zz,
                       mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * ct), out

    (_, jout), (jgp, jgz) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        params, jnp.asarray(z))
    tm = than.SemanticAttention(12, hidden=16)
    tm.load_state_dict(_jax_params(params))
    assert tm.q.shape == (16, 1)
    tz = torch.from_numpy(z).requires_grad_()
    tout = tm(tz, None if mask is None else torch.from_numpy(mask))
    (tout * torch.from_numpy(ct)).sum().backward()
    _close(tout.detach(), jout, F32_FWD, "out")
    _close(tz.grad, jgz, F32_GRAD, "dz")
    _close_grads({k: p.grad for k, p in tm.named_parameters()},
                 _jax_params(jgp), F32_GRAD)
    if masked:   # rows past the mask leave the output unchanged
        z2 = z.copy()
        z2[:, 40:] += 5.0
        out2 = tm(torch.from_numpy(z2), torch.from_numpy(mask))
        torch.testing.assert_close(out2[:37], tout[:37].detach(),
                                   rtol=0, atol=1e-6)


def _han_both(jd, td, dtype, heads=(4,)):
    """HAN from one flax initialisation in both packages, eval mode: the
    logits and every parameter gradient of the training loss."""
    bf16 = dtype == "bfloat16"
    jm = jhan.HAN(num_metapaths=2, num_classes=jd.num_classes, hidden=8,
                  num_heads=heads, dtype=jnp.bfloat16 if bf16 else None)
    params = jm.init(jax.random.PRNGKey(0), jd.graphs, jd.features)["params"]

    def jloss(p):
        logits = jm.apply({"params": p}, jd.graphs, jd.features)
        return j_ce(logits[jd.train_idx], jd.labels[jd.train_idx]), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = than.HAN(int(td.features.shape[1]), 2, td.num_classes, hidden=8,
                  num_heads=heads, dtype=torch.bfloat16 if bf16 else None)
    sd = _jax_params(params)
    assert sorted(sd) == sorted(k for k, _ in tm.named_parameters())
    tm.load_state_dict(sd)
    tm.eval()
    tlogits = tm(td.graphs, td.features)
    t_ce(tlogits[td.train_idx], td.labels[td.train_idx]).backward()
    assert tlogits.dtype == torch.float32
    return (np.asarray(jlogits), _jax_params(jgrads),
            tlogits.detach().numpy(),
            {k: p.grad for k, p in tm.named_parameters()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["coo", "hybrid"])
def test_han_matches_flax(layout, dtype, han_data):
    jd, td = han_data[layout]
    jl, jg, tl, tg = _han_both(jd, td, dtype)
    if dtype == "float32":
        _close(tl, jl, F32_FWD, "logits")
        _close_grads(tg, jg, F32_GRAD)
        return
    _close(tl, jl, BF16, "logits")
    _close_grads(tg, _han_both(jd, td, "float32")[1], BF16)


def test_han_two_layers_matches_flax(han_data):
    """Two HAN layers (heads 2 then 3): ``layer1`` takes ``layer0``'s
    semantic output."""
    jd, td = han_data["hybrid"]
    jl, jg, tl, tg = _han_both(jd, td, "float32", heads=(2, 3))
    assert "layer1.gat_mp1.attn_src" in tg
    _close(tl, jl, F32_FWD, "logits")
    _close_grads(tg, jg, F32_GRAD)


def test_han_hybrid_matches_coo(han_data):
    """One computation on two layouts: the hybrid's logits are the COO
    logits relabelled by the clustering permutation (the split indices
    carry it)."""
    _, coo = han_data["coo"]
    _, hyb = han_data["hybrid"]
    model = than.HAN(128, 2, coo.num_classes)
    model.reset_parameters(torch.Generator().manual_seed(3))
    model.eval()
    with torch.no_grad():
        lc = model(coo.graphs, coo.features)[coo.test_idx]
        lh = model(hyb.graphs, hyb.features)[hyb.test_idx]
    _close(lh, lc, F32_FWD, "hybrid vs coo")


def test_han_dropout_draws_from_the_generator(han_data):
    _, td = han_data["hybrid"]
    model = than.HAN(128, 2, td.num_classes)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train()

    def run(seed):
        return model(td.graphs, td.features,
                     generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))


#: kernels of one HAN epoch (forward and backward), by layout; on COO
#: each metapath's GAT layer runs K1 twice forward (denominator,
#: aggregation) and four times backward (the aggregation's d x, the
#: denominator's read-back, the sender and receiver score gathers)
EPOCH_LAUNCHES = {"coo": {"K1": 12, "K2": 2},
                  "hybrid": {"K4": 2, "K5": 2, "K6": 2}}


@pytest.mark.parametrize("layout", ["coo", "hybrid"])
def test_han_block_matches_eager_under_stub_capture(layout, han_data,
                                                    counted, one_thread,
                                                    monkeypatch):
    """Two chunks of 3 epochs as ``HANBlock`` (warm-up, capture, replays
    under ``StubGraph``) against ``run_han_epochs`` from the same state:
    equal losses, parameters and launch totals; every metapath graph is
    warmed before the capture; the epoch launches ``EPOCH_LAUNCHES``."""
    _, td = han_data[layout]
    monkeypatch.setattr(scan_loop, "EpochGraph", StubGraph)
    spec = make_optimizer("adamw", 5e-3)
    states = [create_train_state(than.HAN(128, 2, td.num_classes), td, 0,
                                 spec) for _ in range(2)]
    warmed = []
    cls = type(td.graphs[0])
    real_warm = cls.warm
    monkeypatch.setattr(cls, "warm",
                        lambda g: warmed.append(g) or real_warm(g))
    block = han_loop.HANBlock(states[0], td, 3)
    rows = [block.run(), block.run()]
    assert len(warmed) == 2 and all(a is b for a, b in zip(warmed,
                                                            td.graphs))
    launches = counters.read_launches()
    assert {k: n for k, n in launches.items() if n} == {
        k: 6 * n for k, n in EPOCH_LAUNCHES[layout].items()}
    counters.reset_launches()
    ref = [han_loop.run_han_epochs(states[1], td, 3) for _ in range(2)]
    assert counters.read_launches() == launches
    for got, want in zip(rows, ref):
        assert got.shape == (3, 1) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for (k, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_han_step_trains_without_dropout(han_data):
    """``han_step`` takes the gradient in eval mode: two states from one
    seed with different dropout generators step identically."""
    _, td = han_data["coo"]
    spec = make_optimizer("adamw", 5e-3)
    states = [create_train_state(than.HAN(128, 2, td.num_classes), td, 0,
                                 spec) for _ in range(2)]
    states[1].generator.manual_seed(12345)
    for st in states:
        st.model.train()
    losses = [float(han_loop.han_step(st, td)) for st in states]
    assert losses[0] == losses[1]
    assert not states[0].model.training


def _jax_cli_losses(argv, monkeypatch):
    """JAX's ``cli.main(argv)``: its result, each chunk's losses and its
    initial parameters, read off the jitted chunk's calls."""
    real_jit = jax.jit
    calls = []

    def recording_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") != "run_chunk":
            return jitted

        def call(params, opt_state):
            out = jitted(params, opt_state)
            calls.append((params, np.asarray(out[2])))
            return out
        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    res = jcli.main(argv)
    monkeypatch.setattr(jax, "jit", real_jit)
    return res, np.concatenate([c[1] for c in calls]), calls[0][0]


@pytest.mark.parametrize("argv", [
    ["--layout", "coo"],
    ["--layout", "hybrid"],
    ["--layout", "hybrid", "--optimizer", "sgd"],
])
def test_cli_han_losses_follow_jax(argv, monkeypatch):
    """8 epochs (one chunk): from JAX's initial parameters, the port's
    per-epoch losses follow JAX's, and the test accuracies agree."""
    argv = ["--model", "han", "--epochs", "8", "--quiet", "--set",
            "n_papers=200"] + argv
    jres, jlosses, jparams = _jax_cli_losses(argv, monkeypatch)
    real_create = han_loop.create_train_state

    def from_jax(model, data, seed, optimizer):
        return real_create(model, data, seed, optimizer,
                           params=_jax_params(jparams))

    monkeypatch.setattr(han_loop, "create_train_state", from_jax)
    losses = []
    real_run = han_loop.run_han_epochs

    def recorded(state, data, n):
        rows = real_run(state, data, n)
        losses.extend(rows[:, 0])
        return rows

    monkeypatch.setattr(han_loop, "run_han_epochs", recorded)
    tres = tcli.main(argv + ["--device", "cpu"])
    assert jlosses.shape == (8,) and len(losses) == 8
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL, atol=0)
    assert tres["epochs"] == 8 and tres["loss"] == losses[-1]
    assert abs(tres["test_acc"] - jres["test_acc"]) <= 2.0 / 200
    assert tres["device"] == "cpu" and tres["seconds"] > 0
    assert "steady_epochs_per_s" not in tres


@pytest.mark.parametrize("argv", [
    ["--dataset", "imdb", "--dtype", "bfloat16"],
    ["--layout", "coo", "--dtype", "bfloat16", "--set", "n_papers=150"],
])
def test_cli_han_runs_on_cpu(argv):
    """IMDB (auto -> hybrid) and ACM's COO graphs, in bfloat16."""
    res = tcli.main(["--model", "han", "--epochs", "3", "--device", "cpu",
                     "--quiet"] + argv)
    assert np.isfinite(res["loss"]) and 0.0 <= res["test_acc"] <= 1.0
    assert res["epochs"] == 3


def test_cli_han_chunks_and_keys():
    """``--epochs 30``: chunks of 20, the last run whole (40 epochs, as
    JAX's loop), and the steady rate past the first chunk."""
    res = tcli.main(["--model", "han", "--epochs", "30", "--device", "cpu",
                     "--quiet", "--layout", "coo", "--set", "n_papers=120"])
    assert res["epochs"] == 40 and res["steady_epochs_per_s"] > 0


def test_cli_han_checks():
    with pytest.raises(SystemExit):
        tcli.main(["--model", "han", "--set", "batch_size=4", "--device",
                   "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["--model", "han_batch", "--layout", "hybrid",
                   "--device", "cpu"])


def test_cli_han_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("han", "han_batch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--model", model, "--epochs", "1", "--quiet"])
