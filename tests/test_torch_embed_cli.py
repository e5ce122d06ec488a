"""The walk embedders through the port's CLI on the CPU, and the edge-list
reader (``graphneuralnetwork_tpu_torch/cli.py``, ``data/edgelist.py``).

Each embedder runs at small ``--set`` sizes with ``--device cpu`` and
must print JAX's keys (``model``, ``final_loss``, ``initial_loss``,
``embed_shape``) with a loss that decreases; LINE and SDNE (no walks)
follow JAX's ``cli.main`` from JAX's initial parameters within
``LOSS_TOL``. ``read_edgelist`` reads files the tests write, equal to
JAX's reader on both packages' Python paths and on their C++ engines'.
What the port does not run (``--set`` keys outside a model's config) is
refused with a message.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.data import edgelist as j_edgelist  # noqa: E402
from graphneuralnetwork_tpu.nn import embed as j_nn  # noqa: E402
from graphneuralnetwork_tpu.sampling import native as j_native  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.data import edgelist as t_edgelist  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import native as t_native  # noqa: E402
from graphneuralnetwork_tpu_torch.train import embed_loop as t_loop  # noqa: E402

#: the CLI's mean epoch losses against JAX's, from the same parameters
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = {"model", "final_loss", "initial_loss", "embed_shape"}
WALKS = ["--set", "num_walks=4", "--set", "walk_length=6", "--set",
         "embed_dim=16", "--epochs", "2"]
RUNS = {
    "deepwalk": (WALKS, [500, 16]),
    "deepwalk_device_walks": (WALKS + ["--set", "device_walks=true"],
                              [500, 16]),
    "node2vec": (WALKS, [500, 16]),
    "node2vec_device_walks": (WALKS + ["--set", "device_walks=true"],
                              [500, 16]),
    "struc2vec": (WALKS + ["--set", "num_walks=1"], [500, 16]),
    "line": (["--set", "embed_dim=16", "--epochs", "2"], [500, 16]),
    "sdne": (["--set", "hidden_dims=64,16", "--epochs", "2"], [500, 16]),
    "metapath2vec": (["--set", "num_walks=5", "--set", "embed_dim=16",
                      "--epochs", "2"], [350, 16]),
    "metapath2vec_device_walks": (
        ["--set", "num_walks=5", "--set", "embed_dim=16", "--set",
         "device_walks=true", "--epochs", "2"], [350, 16]),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_embedders_train_on_cpu(run, capsys):
    argv, shape = RUNS[run]
    model = run.replace("_device_walks", "")
    res = tcli.main(["--model", model, "--device", "cpu", "--quiet", *argv])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert KEYS <= set(out) and out["model"] == model
    assert out["embed_shape"] == shape == res["embed_shape"]
    assert out["epochs"] == 2 and out["device"] == "cpu"
    assert np.isfinite([out["final_loss"], out["initial_loss"]]).all()
    assert out["final_loss"] < out["initial_loss"]


def _jax_cli(argv, capsys):
    jcli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["line", "sdne"])
def test_cli_line_and_sdne_follow_jax(model, capsys, monkeypatch):
    """JAX's CLI and the port's from JAX's initial parameters (flax's
    init depends on the key and the input shapes only)."""
    if model == "line":
        argv = ["--model", "line", "--set", "embed_dim=16", "--epochs", "2"]
        params = j_nn.LINE(500, 16).init(
            jax.random.PRNGKey(0), jnp.zeros((32,), jnp.int32),
            jnp.zeros((32, 6), jnp.int32))["params"]
    else:
        argv = ["--model", "sdne", "--set", "hidden_dims=64,16", "--epochs",
                "2"]
        params = j_nn.SDNE(500, (64, 16)).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 500)))["params"]
    want = _jax_cli(argv + ["--quiet"], capsys)
    state = from_flax(jax.tree.map(np.asarray, params))
    monkeypatch.setattr(t_loop, "_init_params",
                        lambda m, seed: m.load_state_dict(state))
    got = tcli.main(argv + ["--device", "cpu", "--quiet"])
    np.testing.assert_allclose(
        [got["initial_loss"], got["final_loss"]],
        [want["initial_loss"], want["final_loss"]], **LOSS_TOL)
    assert got["embed_shape"] == list(want["embed_shape"])


@pytest.mark.parametrize("argv,message", [
    (["--model", "gatne", "--set", "no_such_key=1"], "not a key"),
    (["--model", "bine", "--set", "no_such_key=1"], "not a key"),
    (["--model", "metapath2vec", "--set", "no_such_key=1"], "not a key"),
    (["--model", "struc2vec", "--set", "device_walks=true"],
     "not a key"),
    (["--model", "line", "--set", "num_walks=2"], "not a key"),
])
def test_cli_refuses_what_is_not_ported(argv, message, capsys):
    with pytest.raises(SystemExit):
        tcli.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def test_cli_embedders_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("deepwalk", "sdne"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--model", model, "--quiet"])


def _write(path, lines):
    path.write_text("".join(line + "\n" for line in lines))
    return str(path)


def _numeric_lines(seed=0, n=40, e=120, weighted=False):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e)
    return [f"{x} {y}" + (f" {z:.4f}" if weighted else "")
            for x, y, z in zip(a * 7 + 3, b * 7 + 3, w)] + ["", "5"]


STRING_LINES = ["alice bob 2.0", "bob carol", "carol alice 0.5", "dave bob",
                "# x", "erin alice 1.5", "bob alice"]


def _same(got, want):
    assert got.n_nodes == want.n_nodes
    for name in ("senders", "receivers", "weights"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got.vocab.idx_to_token == want.vocab.idx_to_token
    assert got.vocab.token_freqs == want.vocab.token_freqs


@pytest.mark.parametrize("kind", ["numeric", "numeric_weighted", "strings"])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("engine", [False, True])
def test_read_edgelist_equals_jax(tmp_path, monkeypatch, kind, directed,
                                  engine):
    """Both packages' Python readers and, where the C++ engines parse the
    file (numeric files), both engines' paths."""
    weighted = kind != "numeric"
    lines = (STRING_LINES if kind == "strings"
             else _numeric_lines(weighted=weighted))
    path = _write(tmp_path / "g.edgelist", lines)
    if not engine:
        for native in (j_native, t_native):
            monkeypatch.setattr(native, "parse_edgelist_native",
                                lambda *a, **k: None)
    got = t_edgelist.read_edgelist(path, weighted=weighted,
                                   directed=directed)
    want = j_edgelist.read_edgelist(path, weighted=weighted,
                                    directed=directed)
    _same(got, want)
    assert got.vocab.idx_to_token[0] == "<UNK>"


def test_load_edgelist_reads_a_file_or_falls_back(tmp_path):
    path = _write(tmp_path / "g.txt", _numeric_lines(seed=2))
    data = t_edgelist.load_edgelist(path)
    assert data.n_nodes == len(data.vocab) and data.vocab is not None
    fallback = t_edgelist.load_edgelist(str(tmp_path / "missing"), seed=3)
    want = j_edgelist.synthetic_smallworld(seed=3)
    np.testing.assert_array_equal(fallback.senders, want.senders)
    assert fallback.n_nodes == 500 and fallback.vocab is None


def test_cli_reads_an_edgelist(tmp_path, capsys):
    path = _write(tmp_path / "g.edgelist", _numeric_lines(seed=4))
    n = t_edgelist.read_edgelist(path).n_nodes
    res = tcli.main(["--model", "deepwalk", "--dataset", path, "--device",
                     "cpu", "--quiet", *WALKS, "--set", "subsample_t=0.01",
                     "--set", "batch_size=32"])
    assert res["embed_shape"] == [n, 16]
    assert res["final_loss"] < res["initial_loss"]


def test_isolation_covers_the_embedder_modules():
    """``test_torch_isolation`` walks every module of the port; the
    embedders' are among them."""
    from tests.test_torch_isolation import _port_modules
    modules = set(_port_modules())
    pkg = "graphneuralnetwork_tpu_torch"
    for name in ("data.edgelist", "models", "models.embedding", "nn.embed",
                 "sampling.device_walks", "sampling.struc2vec",
                 "tools.embed_step", "train.embed_loop"):
        assert f"{pkg}.{name}" in modules


@pytest.mark.parametrize("model", ["deepwalk", "struc2vec"])
def test_step_timing_tool_times_the_trained_corpus(model, monkeypatch):
    """``tools/embed_step.py``'s ``corpus`` is the one that ``run_deepwalk``
    and ``run_struc2vec`` hand to ``train_skipgram``, array for array."""
    from graphneuralnetwork_tpu_torch.models import embedding as t_emb
    from graphneuralnetwork_tpu_torch.tools import embed_step
    data = t_edgelist.synthetic_smallworld(n_nodes=60, seed=0)
    cfg = t_emb.WalkEmbedConfig(num_walks=3, walk_length=6, embed_dim=16,
                                epochs=1, batch_size=32)
    trained = []
    train = t_emb.train_skipgram

    def keep(model, arrays, **kw):
        trained.append(arrays)
        return train(model, arrays, **kw)

    monkeypatch.setattr(t_emb, "train_skipgram", keep)
    getattr(t_emb, f"run_{model}")(data, cfg, device="cpu")
    want = embed_step.corpus(model, data, cfg)
    assert len(trained) == 1 and len(want) == len(trained[0]) == 4
    for got, ref in zip(trained[0], want):
        np.testing.assert_array_equal(got, ref)
