"""GCN and GAT (COO) of the PyTorch port against the flax models: the same
weights (converted by ``params.from_flax``), dropout off, equal logits and
parameter gradients. Tolerance 1e-5 in float32. In bfloat16 the two
frameworks round at different places (XLA on the CPU keeps excess float32
precision where PyTorch rounds each bfloat16 op), so logits are held to
2e-2 of the largest logit and gradients to 2e-2 of the model's largest
gradient entry: the attention-vector gradients are sums that cancel to
~1e-4 of that scale, and bfloat16 noise dominates them in both packages."""

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
from graphneuralnetwork_tpu.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as j_ce)
from graphneuralnetwork_tpu_torch.core.graph import (  # noqa: E402
    gcn_graph as t_gcn_graph)
from graphneuralnetwork_tpu_torch.nn import GAT as TGAT, GCN as TGCN  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy as t_ce)

N_FEATS, N_CLASSES, N_TRAIN = 48, 4, 60
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def small():
    feats, labels, s, r = synthetic_citation_graph(
        n_nodes=160, n_feats=N_FEATS, n_classes=N_CLASSES, seed=1)
    x = row_normalize_features(feats)
    n = x.shape[0]
    return (j_gcn_graph(s, r, n), t_gcn_graph(s, r, n, device="cpu"), x,
            labels.astype(np.int32))


def _models(kind, dtype):
    if kind == "gcn":
        return (JGCN(hidden=16, num_classes=N_CLASSES, dtype=dtype),
                TGCN(N_FEATS, hidden=16, num_classes=N_CLASSES,
                     dtype=None if dtype is None else torch.bfloat16))
    return (JGAT(hidden=4, num_heads=3, num_classes=N_CLASSES, dtype=dtype),
            TGAT(N_FEATS, hidden=4, num_heads=3, num_classes=N_CLASSES,
                 dtype=None if dtype is None else torch.bfloat16))


def _run_both(kind, dtype, small):
    jg, tg, x, labels = small
    jm, tm = _models(kind, dtype)
    params = jm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))["params"]

    def jloss(p):
        logits = jm.apply({"params": p}, jg, jnp.asarray(x))
        return j_ce(logits[:N_TRAIN], jnp.asarray(labels[:N_TRAIN])), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    tm.eval()
    tlogits = tm(tg, torch.from_numpy(x))
    tl = t_ce(tlogits[:N_TRAIN], torch.from_numpy(labels[:N_TRAIN]))
    tl.backward()
    tgrads = {k: p.grad for k, p in tm.named_parameters()}
    return (jl, jlogits, from_flax(jax.tree.map(np.asarray, jgrads))), \
        (tl, tlogits, tgrads)


def test_from_flax_names_and_shapes(small):
    jg, _, x, _ = small
    jm, tm = _models("gat", None)
    params = jm.init(jax.random.PRNGKey(0), jg, jnp.asarray(x))["params"]
    sd = from_flax(jax.tree.map(np.asarray, params))
    assert sorted(sd) == sorted(k for k, _ in tm.named_parameters())
    np.testing.assert_array_equal(
        sd["attn1.linear.weight"].numpy(),
        np.asarray(params["attn1"]["linear"]["kernel"]).T)
    assert sd["attn1.attn_src"].shape == (3, 4)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_logits_and_grads_match_flax_f32(kind, small):
    (jl, jlogits, jgrads), (tl, tlogits, tgrads) = _run_both(
        kind, None, small)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **F32_TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32_TOL)
    assert sorted(jgrads) == sorted(tgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].numpy(), g.numpy(),
                                   err_msg=name, **F32_TOL)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_logits_and_grads_match_flax_bf16(kind, small):
    """Mixed precision: float32 params and logits, bfloat16 compute."""
    (jl, jlogits, jgrads), (tl, tlogits, tgrads) = _run_both(
        kind, jnp.bfloat16, small)
    assert tlogits.dtype == torch.float32
    for p in tgrads.values():
        assert p.dtype == torch.float32
    scale = float(np.abs(np.asarray(jlogits)).max())
    np.testing.assert_allclose(tlogits.detach().numpy() / scale,
                               np.asarray(jlogits) / scale, **BF16_TOL)
    gs = max(float(g.abs().max()) for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].numpy() / gs,
                                   g.numpy() / gs, err_msg=name, **BF16_TOL)


def test_train_mode_dropout_uses_generator(small):
    """Dropout draws come only from the generator passed in: the same seed
    gives the same logits, another seed different ones."""
    _, tg, x, _ = small
    _, tm = _models("gat", None)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    tm.train()
    xs = torch.from_numpy(x)

    def run(seed):
        return tm(tg, xs, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))


ATTENTION_VECTORS = ("attn1.attn_src", "attn1.attn_dst", "attn_out.attn_src",
                     "attn_out.attn_dst")


def test_bf16_attention_vector_grads_track_float32(small):
    """The COO GAT's bfloat16 gradient of each attention vector, against
    that package's own float32 gradient and relative to the tensor's own
    largest entry: the port's error is at most 1.5x the JAX package's.
    These gradients are sums that cancel, so rounding the per-edge products
    of the attention backward to bfloat16 shows here, where the model-wide
    scale of test_logits_and_grads_match_flax_bf16 cannot see it."""
    (_, _, j16), (_, _, t16) = _run_both("gat", jnp.bfloat16, small)
    (_, _, j32), (_, _, t32) = _run_both("gat", None, small)
    for name in ATTENTION_VECTORS:
        def rel(g16, g32):
            return float((g16 - g32).abs().max() / g32.abs().max())
        t_err, j_err = rel(t16[name], t32[name]), rel(j16[name], j32[name])
        assert t_err <= 1.5 * j_err, (name, t_err, j_err)
