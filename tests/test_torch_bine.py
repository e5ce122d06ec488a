"""BiNE of the PyTorch port (``models/bine.py``) against the JAX package on
the CPU: the HITS centralities, the synthetic ratings and each side's
skip-gram corpus equal array for array from the same numpy seed (the
walks draw for draw), one step's loss and gradients from the same tables
and batch within ``SCALE_TOL`` of their largest entry, ``train_bine``
from JAX's initial tables (the port's ``_init_params`` replaced) with its
loss history within ``LOSS_TOL`` and its tables and test metrics within
``TABLE_TOL`` after 2 epochs, the per-term log of ``logdir``, and the
``bine`` CLI against JAX's ``cli.main``, and the three new CLI branches'
refusal to run without a card unless ``--device cpu`` is given."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.models import bine as j_bine  # noqa: E402
from graphneuralnetwork_tpu.train.metrics import optax_sigmoid_bce  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.models import bine as t_bine  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402

SCALE_TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
#: the tables after 2 epochs of AdamW (entries ~0.01-0.1)
TABLE_TOL = dict(rtol=1e-4, atol=2e-5)
D = 16


def jax_initial_tables(nu, nv, seed=0, dim=D):
    """JAX's initial U, V, Cu, Cv (``train_bine``'s draws)."""
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {"U": jax.random.normal(k1, (nu, dim)) * 0.01,
            "V": jax.random.normal(k2, (nv, dim)) * 0.01,
            "Cu": jax.random.normal(k3, (nu, dim)) * 0.01,
            "Cv": jax.random.normal(k4, (nv, dim)) * 0.01}


def _state(tables):
    return from_flax(jax.tree.map(np.asarray, tables))


@pytest.fixture
def jax_tables(monkeypatch):
    """The port's BiNE starts from JAX's initial tables of the default
    ratings (150 users, 120 items)."""
    state = _state(jax_initial_tables(150, 120))
    monkeypatch.setattr(t_bine, "_init_params",
                        lambda m, seed: m.load_state_dict(state))


def test_hits_centrality_equal():
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 30, 200), rng.integers(0, 20, 200)
    for a, b in zip(t_bine.hits_centrality(u, v, 30, 20),
                    j_bine.hits_centrality(u, v, 30, 20)):
        np.testing.assert_array_equal(a, b)


def test_ratings_and_side_corpora_equal(monkeypatch):
    """JAX's ``train_bine`` with no epoch, its HITS, side corpora and test
    edges recorded, against the port's host pipeline from the same seed."""
    seen = {"corpora": []}
    side_dataset = j_bine._side_dataset

    def record_side(*args):
        seen["corpora"].append(side_dataset(*args))
        return seen["corpora"][-1]

    def record_metrics(emb, true_edges, false_edges):
        seen["edges"] = (true_edges, false_edges)
        return {}

    monkeypatch.setattr(j_bine, "_side_dataset", record_side)
    monkeypatch.setattr(j_bine, "link_prediction_metrics", record_metrics)
    j_bine.train_bine(cfg=j_bine.BiNEConfig(epochs=0))

    rng = np.random.default_rng(0)
    bg, ((tu, tv), (fu, fv)) = t_bine.synthetic_ratings(rng)
    (jtu, jtv), (jfu, jfv) = seen["edges"]
    for a, b in ((tu, jtu), (tv + 150, jtv), (fu, jfu), (fv + 150, jfv)):
        np.testing.assert_array_equal(a, b)
    eu, ev, _ = bg.relations[("u", "rate", "v")]
    hub, auth = t_bine.hits_centrality(eu, ev, 150, 120)
    cfg = t_bine.BiNEConfig()
    got = [t_bine._side_dataset(bg, "u", hub, cfg, rng),
           t_bine._side_dataset(bg, "v", auth, cfg, rng)]
    for side, want in zip(got, seen["corpora"]):
        for a, b in zip(side, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _batch(seed=1, nu=30, nv=20, b=24, L=9):
    rng = np.random.default_rng(seed)
    lab = (rng.random((b, L)) < 0.3).astype(np.float32)
    mask = (rng.random((b, L)) < 0.8).astype(np.float32)
    return (rng.integers(0, nu, b).astype(np.int32),
            rng.integers(0, nv, b).astype(np.int32),
            (rng.random(b) * 4 + 1).astype(np.float32),
            rng.integers(0, nu, b).astype(np.int32),
            (rng.integers(0, nu, (b, L)) * mask).astype(np.int32), lab, mask,
            rng.integers(0, nv, b).astype(np.int32),
            (rng.integers(0, nv, (b, L)) * mask).astype(np.int32), lab,
            mask)


def test_bine_loss_and_gradients():
    cfg = t_bine.BiNEConfig()
    init = jax_initial_tables(30, 20)
    batch = _batch()

    def loss_fn(p):
        (e_u, e_v, e_w, cu, cnu, lu, mu, cv, cnv, lv, mv) = map(
            jnp.asarray, batch)
        logit = jnp.sum(p["U"][e_u] * p["V"][e_v], axis=-1)
        o1 = jnp.mean(e_w * optax_sigmoid_bce(logit, jnp.ones_like(logit)))

        def sg(ct, xt, c, cn, lab, mask):
            ls = optax_sigmoid_bce(jnp.einsum("bd,bld->bl", ct[c], xt[cn]),
                                   lab)
            return jnp.sum(ls * mask) / jnp.maximum(mask.sum(), 1.0)

        return (cfg.alpha * o1 + cfg.beta * sg(p["U"], p["Cu"], cu, cnu, lu,
                                               mu)
                + cfg.gamma * sg(p["V"], p["Cv"], cv, cnv, lv, mv))

    want, grads = jax.value_and_grad(loss_fn)(init)
    tables = t_bine.BiNETables(30, 20, D)
    tables.load_state_dict(_state(init))
    got, terms = t_bine.bine_loss(
        tables, cfg, t_bine.batch_to_device(batch, 30, 20,
                                            torch.device("cpu")))
    got.backward()
    got = got.item()
    assert abs(got - float(want)) <= SCALE_TOL * abs(float(want))
    assert terms.shape == (3,)
    for k, g in _state(grads).items():
        scale = float(np.abs(g.numpy()).max())
        err = float((getattr(tables, k).grad - g).abs().max())
        assert err <= SCALE_TOL * scale, (k, err / scale)


def test_train_bine_follows_jax(jax_tables):
    j_params, j_hist, j_metrics = j_bine.train_bine(
        cfg=j_bine.BiNEConfig(embed_dim=D, epochs=2))
    t_params, t_hist, t_metrics = t_bine.train_bine(
        cfg=t_bine.BiNEConfig(embed_dim=D, epochs=2), device="cpu")
    np.testing.assert_allclose([h[1] for h in t_hist],
                               [h[1] for h in j_hist], **LOSS_TOL)
    assert t_hist[-1][1] < t_hist[0][1]
    for k, v in _state(j_params).items():
        np.testing.assert_allclose(t_params[k].numpy(), v.numpy(),
                                   **TABLE_TOL)
    assert set(t_metrics) == set(j_metrics)
    for k in ("auc", "loss"):
        assert abs(t_metrics[k] - j_metrics[k]) <= 1e-4


def test_train_bine_logs_each_term(tmp_path, jax_tables):
    """``logdir`` writes the three terms at every step (TensorBoard, or the
    JSONL fallback) and changes no value (within float32 rounding: two
    CPU threads sum the gathers' backward in either order)."""
    cfg = dict(embed_dim=D, epochs=1)
    _, plain, _ = t_bine.train_bine(cfg=t_bine.BiNEConfig(**cfg),
                                    device="cpu")
    _, logged, _ = t_bine.train_bine(
        cfg=t_bine.BiNEConfig(logdir=str(tmp_path), **cfg), device="cpu")
    np.testing.assert_allclose([h[1] for h in logged],
                               [h[1] for h in plain], rtol=1e-6)
    assert any(tmp_path.iterdir())
    events = tmp_path / "events.jsonl"
    if events.exists():
        rows = [json.loads(x) for x in events.read_text().splitlines()]
        assert {r["tag"] for r in rows} == {
            "loss/o1_explicit", "loss/o2_implicit_u", "loss/o3_implicit_v"}
        assert max(r["step"] for r in rows) == 10


def _jax_cli(argv, capsys):
    jcli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_bine_follows_jax(capsys, jax_tables):
    argv = ["--model", "bine", "--set", f"embed_dim={D}", "--epochs", "2",
            "--quiet"]
    want = _jax_cli(argv, capsys)
    got = tcli.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(want) <= set(out) and out["model"] == "bine"
    assert out["device"] == "cpu" and out["epochs"] == 2
    np.testing.assert_allclose(
        [got["initial_loss"], got["final_loss"]],
        [want["initial_loss"], want["final_loss"]], **LOSS_TOL)
    assert set(got["test_metrics"]) == set(want["test_metrics"])
    assert abs(got["test_metrics"]["auc"] - want["test_metrics"]["auc"]) \
        <= 1e-4


def test_cli_linkpred_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("gatne", "bine", "basis"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--model", model, "--quiet"])
