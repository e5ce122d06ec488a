"""The CLI's (model, layout) gate against the JAX package's.

JAX's ``cli.main`` refuses ``--layout hybrid`` for every model but gcn,
gat, graphsage and han, and ``--layout sparse`` for every model but gtn,
before it loads any data. The port's ``cli.main`` refuses the same pairs,
but for ``graphsage_unsup --layout hybrid``, which trains the sampled
unsupervised loop on purpose (``test_torch_train.py::
test_cli_sampled_graphsage_not_ported``). Each refused pair runs through
both CLIs, and both must exit with an error that names the layout.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402

MODELS = ["gcn", "gat", "graphsage", "graphsage_unsup", "han", "han_batch",
          "gtn", "deepwalk", "node2vec", "struc2vec", "line", "sdne",
          "metapath2vec", "gatne", "bine", "basis"]
#: the models JAX's CLI serves on each layout but auto and coo
JAX_LAYOUT_MODELS = {"hybrid": ("gcn", "gat", "graphsage", "han"),
                     "sparse": ("gtn",)}
REFUSED = [(m, layout) for layout, ok in JAX_LAYOUT_MODELS.items()
           for m in MODELS if m not in ok
           and (m, layout) != ("graphsage_unsup", "hybrid")]


def test_the_refused_pairs_include_the_fault():
    """The six walk embedders, gatne, bine and basis under hybrid, which
    the port's CLI trained (ignoring the layout) before its gate took
    JAX's."""
    for m in ("deepwalk", "node2vec", "struc2vec", "line", "sdne",
              "metapath2vec", "gatne", "bine", "basis"):
        assert (m, "hybrid") in REFUSED
    assert len(REFUSED) == 11 + 15


@pytest.mark.parametrize("model, layout", REFUSED,
                         ids=[f"{m}-{lay}" for m, lay in REFUSED])
def test_both_clis_refuse_the_layout(model, layout, capsys):
    argv = ["--model", model, "--layout", layout]
    with pytest.raises(SystemExit) as jexit:
        jcli.main(argv + ["--quiet"])
    assert f"--layout {layout} is not supported" in str(jexit.value.code)
    with pytest.raises(SystemExit) as texit:
        tcli.main(argv + ["--device", "cpu", "--quiet", "--epochs", "1"])
    assert texit.value.code != 0
    err = capsys.readouterr().err
    assert f"--layout {layout} is not supported for --model {model}" in err
