"""GATNE's training loops (``models/gatne.py``) against the JAX package on
the CPU, from JAX's initial values (the port's ``_init_params`` replaced
by flax's ``init`` of the same shapes and JAX's ``ctx``/``decoder``
draws, carried over by ``params.from_flax``).

Both losses, in both of JAX's loops: the host loop (JAX's CPU loop, the
port's on the CPU) and the device loop (JAX's ``lax.scan`` loop, run here
on the CPU by reporting another backend to JAX's module; the port's
``HostDrawnEpochs``, eager on the CPU). Each draws its batches and
negatives from the same numpy seed, so the mean epoch losses must agree
within ``LOSS_TOL`` and every node's embedding under every edge type after
2 epochs within ``DUMP_TOL``. The runs take lr 1e-3: at the default 1e-2
the training itself amplifies float32 rounding (a relative change of 1e-6
in the port's own initial values moves GATNE-I's parameters by up to 0.75
after 2 epochs), so no two float32 implementations agree there.

The ``gatne`` CLI follows JAX's ``cli.main`` from JAX's initial values
(the test metrics within ``METRIC_TOL``), for both losses.

The captured path of ``HostDrawnEpochs`` (a warm-up step, one captured
step, replays) runs on the CPU under a stand-in graph whose replay reruns
the captured step, and must equal the eager epochs bit for bit (on one
thread).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.data import edgelist as j_edgelist  # noqa: E402
from graphneuralnetwork_tpu.models import gatne as j_gatne  # noqa: E402
from graphneuralnetwork_tpu.nn import embed as j_nn  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.models import gatne as t_gatne  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import embed_loop as t_loop  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
DUMP_TOL = dict(rtol=1e-4, atol=1e-5)
#: the held-out metrics of the final embeddings (a score crossing the 0
#: threshold moves accuracy and F1 by a whole edge; AUC and BCE move
#: smoothly)
METRIC_TOL = 1e-4
SMALL = dict(embed_dim=16, num_walks=2, walk_length=5, epochs=2,
             batch_size=256, lr=1e-3)


def jax_initial_values(data, cfg):
    """JAX's initial ``{"model", "ctx"|"decoder"}`` tree for ``cfg`` (flax's
    init depends on the key and the input shapes only)."""
    inductive = cfg.inductive and data.features is not None
    T = len(data.edge_types)
    model = j_nn.GATNE(
        vocab_size=data.n_nodes, num_edge_types=T, embed_dim=cfg.embed_dim,
        edge_embed_dim=cfg.edge_embed_dim, attn_dim=cfg.attn_dim,
        inductive=inductive,
        feature_dim=data.features.shape[1] if inductive else None,
        aggregator=cfg.aggregator)
    params = model.init(
        jax.random.PRNGKey(cfg.seed), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, T, cfg.neighbor_samples), jnp.int32),
        jnp.asarray(data.features) if inductive else None)["params"]
    key = jax.random.PRNGKey(cfg.seed + 1)
    shape = (data.n_nodes, cfg.embed_dim)
    if cfg.loss == "masked_bce":
        lim = float(np.sqrt(6.0 / sum(shape)))
        table = {"decoder": jax.random.uniform(key, shape, minval=-lim,
                                               maxval=lim)}
    else:
        table = {"ctx": jax.random.normal(key, shape) * 0.01}
    return model, {"model": params, **table}


def _jax_dump(model, params, data, cfg):
    """JAX's [T, N, D] embedding of every node under every type."""
    nb = jnp.asarray(j_gatne.build_neighbor_tables(
        data, cfg.neighbor_samples, np.random.default_rng(cfg.seed)))
    feats = (jnp.asarray(data.features) if cfg.inductive else None)
    nodes = jnp.arange(data.n_nodes, dtype=jnp.int32)
    return np.stack([np.asarray(model.apply(
        {"params": params["model"]}, nodes,
        jnp.full((data.n_nodes,), t, jnp.int32), nb, feats))
        for t in range(len(data.edge_types))])


def _port_dump(state, data, cfg):
    params = t_gatne.GATNEParams(data, cfg)
    params.load_state_dict(state)
    nb = torch.from_numpy(t_gatne.build_neighbor_tables(
        data, cfg.neighbor_samples, np.random.default_rng(cfg.seed)))
    return t_gatne.embed_all(params, nb)


CASES = {
    "nsloss_host": dict(loss="nsloss"),
    "masked_bce_host": dict(loss="masked_bce"),
    "nsloss_device_inductive_sum": dict(loss="nsloss", inductive=True,
                                        aggregator="sum", device_loop=True),
    "masked_bce_device_inductive": dict(loss="masked_bce", inductive=True,
                                        device_loop=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_gatne_follows_jax(case, monkeypatch):
    kw = dict(CASES[case])
    device_loop = kw.pop("device_loop", False)
    data = j_edgelist.synthetic_multiplex(seed=0)
    j_cfg = j_gatne.GATNEConfig(**SMALL, **kw)
    t_cfg = t_gatne.GATNEConfig(**SMALL, **kw)
    model, init = jax_initial_values(data, j_cfg)
    state = from_flax(jax.tree.map(np.asarray, init))
    monkeypatch.setattr(t_gatne, "_init_params",
                        lambda p, seed: p.load_state_dict(state))
    for mod in (j_gatne, t_gatne):
        monkeypatch.setattr(mod, "uniform_walks", functools.partial(
            mod.uniform_walks, use_native=False))
    with monkeypatch.context() as m:
        if device_loop:
            m.setattr(j_gatne.jax, "default_backend", lambda: "gpu")
        j_params, j_hist, j_test = j_gatne.train_gatne(data, j_cfg)
    t_state, t_hist, t_test = t_gatne.train_gatne(
        data, t_cfg, device="cpu", device_loop=device_loop)
    np.testing.assert_allclose([h[1] for h in t_hist],
                               [h[1] for h in j_hist], **LOSS_TOL)
    assert t_hist[-1][1] < t_hist[0][1]
    np.testing.assert_allclose(_port_dump(t_state, data, t_cfg),
                               _jax_dump(model, j_params, data, j_cfg),
                               **DUMP_TOL)
    for k in ("auc", "loss"):
        assert abs(t_test[k] - j_test[k]) <= METRIC_TOL, (k, t_test, j_test)
        assert abs(t_hist[-1][2][k] - j_hist[-1][2][k]) <= METRIC_TOL


@pytest.mark.parametrize("loss", ["nsloss", "masked_bce"])
def test_cli_gatne_follows_jax(loss, capsys, monkeypatch):
    small = {k: v for k, v in SMALL.items() if k != "epochs"}
    argv = ["--model", "gatne", "--epochs", "2", "--quiet", "--set",
            f"loss={loss}"] + [x for k, v in small.items()
                               for x in ("--set", f"{k}={v}")]
    data = j_edgelist.synthetic_multiplex(seed=0)
    _, init = jax_initial_values(data, j_gatne.GATNEConfig(loss=loss,
                                                           **SMALL))
    state = from_flax(jax.tree.map(np.asarray, init))
    monkeypatch.setattr(t_gatne, "_init_params",
                        lambda p, seed: p.load_state_dict(state))
    for mod in (j_gatne, t_gatne):
        monkeypatch.setattr(mod, "uniform_walks", functools.partial(
            mod.uniform_walks, use_native=False))
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(out) and out["model"] == "gatne"
    assert out["epochs"] == 2 and out["device"] == "cpu"
    assert out["final_loss"] < out["initial_loss"]
    assert set(got["test_metrics"]) == set(want["test_metrics"])
    for k in ("auc", "loss"):
        assert abs(got["test_metrics"][k] - want["test_metrics"][k]) \
            <= METRIC_TOL


def test_train_gatne_rejects_an_unknown_loss():
    with pytest.raises(ValueError, match="loss"):
        t_gatne.train_gatne(cfg=t_gatne.GATNEConfig(loss="hinge"),
                            device="cpu")


class _StubGraph:
    """A CUDA graph's semantics on the CPU as ``CapturedEpochs`` sees them:
    the warm-up runs, the capture records without running, a replay
    reruns the recorded step."""

    def __init__(self, device):
        self.step = None

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        self.step = fn

    def replay(self):
        self.step()


@pytest.mark.parametrize("loss", ["nsloss", "masked_bce"])
def test_host_drawn_epochs_captured_equal_eager(loss, monkeypatch):
    """Two epochs of the device loop through the captured path (warm-up,
    capture, replays, under ``_StubGraph``) against the same two epochs
    stepped eagerly from the same values and arrays: the losses and every
    parameter bit-equal, on one thread (two make the CPU's gathers'
    backward, an ``index_put_`` accumulation, nondeterministic)."""
    monkeypatch.setattr(t_loop, "EpochGraph", _StubGraph)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _captured_vs_eager(loss)
    finally:
        torch.set_num_threads(threads)


def _captured_vs_eager(loss):
    data = t_gatne.load_multiplex(seed=0)
    cfg = t_gatne.GATNEConfig(loss=loss, **SMALL)
    rng = np.random.default_rng(0)
    nb_tab = torch.from_numpy(t_gatne.build_neighbor_tables(
        data, cfg.neighbor_samples, rng))
    source = t_gatne._Batches(data, cfg, rng)
    nb = len(source) // cfg.batch_size
    epochs = [source.epoch(rng, nb) for _ in range(2)]
    fn = t_gatne.masked_bce if loss == "masked_bce" else t_gatne.nsloss
    runs = []
    for captured in (True, False):
        params, opt = t_gatne.gatne_model(data, cfg, torch.device("cpu"))
        loop = t_loop.HostDrawnEpochs(
            t_gatne.make_step(params, opt, fn, nb_tab), epochs[0],
            cfg.batch_size, opt, torch.device("cpu"))
        if captured:
            # the card's path: CapturedEpochs.run branches on the device
            loop.loop.device = torch.device("cuda")
        losses = [loop.run(a) if captured else loop.run_eager(a)
                  for a in epochs]
        runs.append((losses, params.state_dict()))
    (cap, cap_state), (eager, eager_state) = runs
    assert len(cap[0]) == nb
    for a, b in zip(cap, eager):
        np.testing.assert_array_equal(a, b)
    for k, v in cap_state.items():
        assert torch.equal(v, eager_state[k]), k
    assert np.mean(cap[1]) < np.mean(cap[0])
