"""The JData pipeline of the PyTorch port (``graphneuralnetwork_tpu_torch/
data/jdata.py`` and ``--model metapath2vec --dataset``) against the JAX
package on the CPU.

``tests/test_jdata.py``'s cases run through the port on raw CSVs the test
writes (its ``_write_raw``): ``process_jdata`` gives JAX's DataFrames and
writes JAX's four files byte for byte, and ``load_jdata`` then gives
JAX's ``HeteroGraph``, metapath, type offsets, vocabularies and feature
tables, array for array, with and without sampling the actions; the
synthetic fallback (no ``data_action.csv``) gives JAX's arrays too. The
CLI trains on a processed directory and on an empty one (the fallback)
and follows JAX's ``cli.main`` from JAX's initial parameters: its epoch
losses within ``LOSS_TOL`` (Adam steps on gradients that differ by float32
rounding, as in ``test_torch_embed_cli.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.data import jdata as j_jdata  # noqa: E402
from graphneuralnetwork_tpu.nn import embed as j_nn  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.data import jdata as t_jdata  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train import embed_loop as t_loop  # noqa: E402
from tests.test_jdata import _write_raw  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
FILES = ("user_features.csv", "item_features.csv", "node_features.csv",
         "data_action.csv")


def _same_jdata(got, want):
    assert got.hetero.node_counts == want.hetero.node_counts
    assert list(got.hetero.relations) == list(want.hetero.relations)
    for key, arrays in want.hetero.relations.items():
        for g, w in zip(got.hetero.relations[key], arrays):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert got.metapath == want.metapath
    assert got.type_offsets == want.type_offsets
    assert got.idx_to_users == want.idx_to_users
    assert got.idx_to_items == want.idx_to_items
    for name in ("user_features", "item_features"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None
        else:
            pd.testing.assert_frame_equal(g, w)


@pytest.fixture
def raw(tmp_path):
    """Raw JData CSVs, processed by JAX into ``jax/`` and by the port into
    ``torch/``."""
    src = tmp_path / "raw"
    src.mkdir()
    _write_raw(src, np.random.default_rng(42))
    return src, tmp_path / "jax", tmp_path / "torch"


def test_age_buckets_equal_jax():
    for age in ("-1", "15岁以下", "16-25岁", "26-35岁", "36-45岁", "46-55岁",
                "56岁以上", "bogus", -1, None):
        assert t_jdata.convert_age(age) == j_jdata.convert_age(age)
    assert t_jdata.convert_age("56岁以上") == 6
    assert t_jdata.convert_age("bogus") == -1


def test_process_then_load_equals_jax(raw):
    src, j_out, t_out = raw
    j_nodes, j_action = j_jdata.process_jdata(str(src), str(j_out))
    t_nodes, t_action = t_jdata.process_jdata(str(src), str(t_out))
    pd.testing.assert_frame_equal(t_nodes, j_nodes)
    pd.testing.assert_frame_equal(t_action, j_action)
    for name in FILES:
        assert (t_out / name).read_bytes() == (j_out / name).read_bytes()
    assert t_action["user_id"].str.startswith("u_").all()
    got = t_jdata.load_jdata(str(t_out), seed=0)
    _same_jdata(got, j_jdata.load_jdata(str(j_out), seed=0))
    assert got.hetero.node_counts["user"] == t_action["user_id"].nunique()
    assert got.type_offsets["item"] == len(got.idx_to_users)
    assert got.user_features is not None


@pytest.mark.parametrize("sample_num,seed", [(40, 0), (40, 3), (10000, 1)])
def test_load_jdata_samples_as_jax(raw, sample_num, seed):
    src, j_out, _ = raw
    j_jdata.process_jdata(str(src), str(j_out))
    got = t_jdata.load_jdata(str(j_out), sample_num=sample_num, seed=seed)
    want = j_jdata.load_jdata(str(j_out), sample_num=sample_num, seed=seed)
    _same_jdata(got, want)
    if sample_num == 40:
        assert sum(len(r[0]) for r in got.hetero.relations.values()) == 80


@pytest.mark.parametrize("where", [None, "empty"])
@pytest.mark.parametrize("seed", [0, 1])
def test_load_jdata_synthetic_fallback_equals_jax(tmp_path, where, seed):
    root = None if where is None else str(tmp_path)
    got = t_jdata.load_jdata(root, seed=seed)
    _same_jdata(got, j_jdata.load_jdata(root, seed=seed))
    assert got.hetero.node_counts["user"] > 0
    assert got.metapath[0][0] == "user"
    assert got.user_features is None
    u, i = t_jdata._synthetic_actions(seed)
    assert (u, i) == j_jdata._synthetic_actions(seed)


def _skipgram_init(vocab, dim, seed):
    """JAX's ``train_skipgram`` initial parameters: flax's init depends on
    the key and the parameter shapes only."""
    return j_nn.SkipGram(vocab, dim).init(
        jax.random.PRNGKey(seed), jnp.zeros((2,), jnp.int32),
        jnp.zeros((2, 3), jnp.int32))["params"]


@pytest.mark.parametrize("dataset", ["processed", "empty"])
def test_cli_metapath2vec_dataset_follows_jax(raw, dataset, capsys,
                                              monkeypatch):
    src, j_out, _ = raw
    if dataset == "processed":
        j_jdata.process_jdata(str(src), str(j_out))
        n_total = sum(t_jdata.load_jdata(str(j_out)).hetero.node_counts
                      .values())
    else:
        j_out.mkdir()
        n_total = 350
    argv = ["--model", "metapath2vec", "--dataset", str(j_out), "--epochs",
            "2", "--quiet", "--set", "num_walks=5", "--set", "embed_dim=16",
            "--set", "batch_size=16"]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    state = from_flax(jax.tree.map(np.asarray,
                                   _skipgram_init(n_total, 16, 0)))
    monkeypatch.setattr(t_loop, "_init_params",
                        lambda model, seed: model.load_state_dict(state))
    got = tcli.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "metapath2vec" and out["device"] == "cpu"
    assert got["embed_shape"] == list(want["embed_shape"]) == [n_total, 16]
    np.testing.assert_allclose(
        [got["initial_loss"], got["final_loss"]],
        [want["initial_loss"], want["final_loss"]], **LOSS_TOL)
    assert got["final_loss"] < got["initial_loss"]
