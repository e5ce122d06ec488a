"""Training with the PyTorch port against the JAX package on the CPU: loss
trajectories from the same initial weights, the REPRO accuracy criterion,
checkpoints, and the CLI's device and layout rules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core.graph import (  # noqa: E402
    gcn_graph as j_gcn_graph, row_normalize_features)
from graphneuralnetwork_tpu.data.planetoid import (  # noqa: E402
    synthetic_citation_graph)
from graphneuralnetwork_tpu.nn import GAT as JGAT, GCN as JGCN  # noqa: E402
from graphneuralnetwork_tpu.train.loop import (  # noqa: E402
    create_train_state as j_create, make_node_classification_step)
from graphneuralnetwork_tpu.train.schedule import (  # noqa: E402
    make_optimizer as j_make_optimizer, warmup_poly_schedule as j_sched)
from graphneuralnetwork_tpu_torch.cli import main  # noqa: E402
from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    gcn_graph as t_gcn_graph)
from graphneuralnetwork_tpu_torch.data import (  # noqa: E402
    NodeClassificationData, load_cora)
from graphneuralnetwork_tpu_torch.nn import GAT as TGAT, GCN as TGCN  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import (  # noqa: E402
    create_train_state, fit_node_classifier, fit_node_classifier_scan,
    make_optimizer, restore_checkpoint, save_checkpoint, train_step)
from graphneuralnetwork_tpu_torch.train.schedule import (  # noqa: E402
    warmup_poly_factor)

N_FEATS, N_CLASSES, STEPS = 48, 4, 5
#: 5-step losses: float32 sums in other orders, then Adam's normalised
#: steps; the measured gap is ~1e-7.
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def small():
    feats, labels, s, r = synthetic_citation_graph(
        n_nodes=160, n_feats=N_FEATS, n_classes=N_CLASSES, seed=1)
    x = row_normalize_features(feats)
    n = x.shape[0]
    tdata = NodeClassificationData(
        graph=t_gcn_graph(s, r, n, device="cpu"), features=torch.from_numpy(x),
        labels=torch.from_numpy(labels.astype(np.int64)),
        train_idx=torch.arange(0, 60), val_idx=torch.arange(60, 110),
        test_idx=torch.arange(110, 160), num_classes=N_CLASSES,
        device=torch.device("cpu"))
    return j_gcn_graph(s, r, n), x, labels.astype(np.int32), tdata


def _models(kind):
    if kind == "gcn":
        return (JGCN(hidden=16, num_classes=N_CLASSES, dropout=0.0),
                TGCN(N_FEATS, hidden=16, num_classes=N_CLASSES, dropout=0.0))
    return (JGAT(hidden=4, num_heads=2, num_classes=N_CLASSES, dropout=0.0),
            TGAT(N_FEATS, hidden=4, num_heads=2, num_classes=N_CLASSES,
                 dropout=0.0))


OPTIMIZERS = {
    "adamw": dict(name="adamw", lr=1e-2, weight_decay=5e-4),
    "sgd": dict(name="sgd", lr=0.2, weight_decay=5e-4, total_steps=20,
                warmup_steps=1, momentum=0.9),
}


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_five_step_loss_trajectory_matches_jax(kind, opt, small):
    jg, x, labels, tdata = small
    jm, tm = _models(kind)
    cfg = OPTIMIZERS[opt]
    jstate = j_create(jm, jg, jnp.asarray(x), jax.random.PRNGKey(0),
                      j_make_optimizer(**cfg))
    step = make_node_classification_step(jm)
    tstate = create_train_state(
        tm, tdata, 0, make_optimizer(**cfg),
        params=from_flax(jax.tree.map(np.asarray, jstate.params)))
    jl, tl = [], []
    for _ in range(STEPS):
        jstate, loss, _ = step(jstate, jg, jnp.asarray(x),
                               jnp.asarray(labels), jnp.arange(60))
        jl.append(float(loss))
        tl.append(float(train_step(tstate, tdata)[0]))
    np.testing.assert_allclose(tl, jl, **TRAJ_TOL)
    assert tl[-1] < tl[0]


def test_schedule_factor_matches_optax_count():
    """LambdaLR sets the factor of step 0 when built and the loop steps it
    after each update, so update t uses factor(t), as optax's count does."""
    total, warm, lr = 30, 3, 0.5
    ref = j_sched(lr, total, warm)
    t = make_optimizer("sgd", lr, total_steps=total, warmup_steps=warm)
    opt, sched = t.build([torch.nn.Parameter(torch.zeros(1))])
    for step in range(total + 2):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(ref(step)), rtol=1e-6)
        np.testing.assert_allclose(
            lr * warmup_poly_factor(step, total, warm), float(ref(step)),
            rtol=1e-6)
        opt.step()
        sched.step()


@pytest.fixture(scope="module")
def cora_cpu():
    return load_cora(seed=0, device="cpu")


def test_gcn_reaches_repro_accuracy_on_cora_synthetic(cora_cpu):
    """REPRO.md criterion (test_acc >= 0.80) with the verify recipe:
    GCN hidden 32, AdamW 2e-2 (optax's default decay 1e-4), 200 epochs."""
    data = cora_cpu
    res = fit_node_classifier(
        TGCN(data.features.shape[1], hidden=32,
             num_classes=data.num_classes),
        data, epochs=200, optimizer=make_optimizer("adamw", 2e-2,
                                                   weight_decay=1e-4),
        eval_every=40, patience=5, seed=0)
    assert res.test_acc >= 0.80, res.test_acc


def test_scan_history_and_best_params_selection(small):
    """History per block; test uses the best-val params."""
    tdata = small[3]
    _, tm = _models("gcn")
    res = fit_node_classifier_scan(
        tm, tdata, epochs=60, optimizer=make_optimizer("adamw", 2e-2),
        epochs_per_call=20, patience_calls=99, seed=0)
    assert [h[0] for h in res.history] == [20, 40, 60]
    assert res.best_val_loss <= min(h[3] for h in res.history) + 1e-9
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, res.best_params[k], rtol=0, atol=0)


def test_scan_early_stop_triggers_before_budget(small):
    tdata = small[3]
    _, tm = _models("gcn")
    res = fit_node_classifier_scan(
        tm, tdata, epochs=400, optimizer=make_optimizer("adamw", 5.0),
        epochs_per_call=10, patience_calls=1, seed=0)
    assert res.epochs_run < 400


def test_checkpoint_save_and_resume_round_trip(small, tmp_path):
    tdata = small[3]
    spec = make_optimizer(**OPTIMIZERS["sgd"])
    a = create_train_state(_models("gat")[1], tdata, 0, spec)
    for _ in range(3):
        train_step(a, tdata)
    save_checkpoint(str(tmp_path), a, 3)

    b = create_train_state(_models("gat")[1], tdata, 1, spec)
    b, step = restore_checkpoint(str(tmp_path), b)
    assert step == 3
    for (k, va), (_, vb) in zip(a.model.state_dict().items(),
                                b.model.state_dict().items()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    assert b.scheduler.last_epoch == a.scheduler.last_epoch == 3
    # the next step continues identically (momentum buffers, lr schedule)
    la, lb = train_step(a, tdata)[0], train_step(b, tdata)[0]
    assert float(la) == float(lb)
    for va, vb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def test_restore_missing_checkpoint_raises(small, tmp_path):
    state = create_train_state(_models("gcn")[1], small[3], 0,
                               make_optimizer("adamw", 1e-2))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)


@pytest.mark.parametrize("argv", [
    ["--model", "gcn", "--epochs", "2"],
    ["--model", "gcn", "--epochs", "2", "--dtype", "bfloat16",
     "--optimizer", "sgd", "--layout", "coo"],
    ["--model", "gat", "--layout", "coo", "--epochs", "2"],
])
def test_cli_cpu_runs_complete(argv, tmp_path):
    res = main(argv + ["--device", "cpu", "--quiet",
                       "--checkpoint-dir", str(tmp_path)])
    assert res["epochs"] == 2 and res["device"] == "cpu"
    assert np.isfinite(res["loss"]) and 0.0 <= res["test_acc"] <= 1.0
    assert (tmp_path / "checkpoint.pt").exists()
    again = main(argv + ["--device", "cpu", "--quiet", "--resume",
                         "--checkpoint-dir", str(tmp_path)])
    assert again["epochs"] == 2


def test_cli_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", "gcn", "--epochs", "1", "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_cora(seed=0)


@pytest.mark.parametrize("argv", [
    # GCN on the hybrid layout trains on K3 (tiles) and K1 (remainder)
    ["--model", "gcn", "--layout", "hybrid", "--dtype", "bfloat16"],
    ["--model", "gcn", "--layout", "hybrid"],
])
def test_cli_hybrid_layout_not_ported(argv):
    """Kept under its first name: GCN on the hybrid layout raised before
    K3 was ported, and now trains."""
    res = main(argv + ["--device", "cpu", "--quiet", "--epochs", "2"])
    assert res["epochs"] == 2 and res["device"] == "cpu"
    assert np.isfinite(res["loss"]) and 0.0 <= res["test_acc"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["--model", "graphsage"],
    ["--model", "graphsage", "--layout", "coo"],
    ["--model", "graphsage_unsup", "--layout", "hybrid"],
])
def test_cli_sampled_graphsage_not_ported(argv):
    with pytest.raises(NotImplementedError,
                       match="sampled GraphSAGE.*ROADMAP.md queue 1 item 10b"):
        main(argv + ["--device", "cpu", "--quiet", "--epochs", "1"])
