"""The wedge-plan GTN on a plan sharded over a mesh
(``parallel/gtn_sparse.py``) of the PyTorch port against the JAX
package's on the CPU.

Host arrays: ``shard_gtn_plan``'s wedge arrays, slot counts and padded
widths byte-equal to JAX's for D = 2 and 4, on JAX's test plans and on a
plan that leaves a rank no slot and no wedge. A gloo world of D spawned
processes (``torch_world.py``, only the port) runs ``SparseGTN`` on the
sharded plan: every rank's logits (JAX's tolerance ``2e-5``) and its
gradients of the sum of squared logits (``2e-4``) against JAX's
single-device model from the same flax parameters, with no all-reduce
after the backward; the blocked composition (``wedge_block=257``) against
the unblocked one on the sharded plan; and the plan with an empty rank
against the port's single-device model; at D = 4, the plan sharded over
the "data" axis of a 2×2 mesh. The cases mirror
``tests/test_gtn_sharded.py``. Each world is spawned once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from jax.sharding import Mesh as JMesh  # noqa: E402

from graphneuralnetwork_tpu.nn import gtn_sparse as jsparse  # noqa: E402
from graphneuralnetwork_tpu.parallel.gtn_sparse import (  # noqa: E402
    shard_gtn_plan as j_shard_gtn_plan)
from graphneuralnetwork_tpu_torch.nn import gtn_sparse as tsparse  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel import Mesh  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel.gtn_sparse import (  # noqa: E402
    shard_gtn_plan)

import torch_world  # noqa: E402

WORLDS = (2, 4)
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
BLOCKED_TOL = dict(atol=1e-4, rtol=1e-4)
LEAVES = ("sh_h_idx", "sh_type", "sh_a_val", "sh_out_loc")


def _small(seed=0, n=60, t=4, e=150):
    """JAX's test stack: ``t - 1`` random edge types and the identity."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((t, n, n), np.float32)
    for k in range(t - 1):
        idx = rng.integers(0, n, (2, e))
        adj[k][idx[0], idx[1]] = 1.0
    adj[t - 1] = np.eye(n, dtype=np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return adj, x


def _sparse3():
    """One edge (0 -> 1) and the identity over 3 nodes: each composition
    has 4 output slots and 5 wedges, and at D = 4 one rank gets no slot
    and no wedge (its compose is K1 over an empty order)."""
    adj = np.zeros((2, 3, 3), np.float32)
    adj[0, 0, 1] = 1.0
    adj[1] = np.eye(3, dtype=np.float32)
    x = np.random.default_rng(3).normal(size=(3, 16)).astype(np.float32)
    return adj, x


STACKS = {"seed0": lambda: _small(0), "seed1": lambda: _small(1),
          "seed2": lambda: _small(2), "empty_rank": _sparse3}


def _plans(name):
    adj, x = STACKS[name]()
    n = adj.shape[1]
    j = jsparse.build_gtn_plan(jsparse.stacked_adj_to_sparse(adj), n,
                               num_layers=2)
    args = (tsparse.stacked_adj_to_sparse(adj), n, 2)
    return adj, x, j, args


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_shard_arrays_equal_jax(d, stack):
    _, _, j, args = _plans(stack)
    t = shard_gtn_plan(tsparse.build_gtn_plan(*args, device="cpu"),
                       Mesh.layout(d))
    js = j_shard_gtn_plan(j, JMesh(np.array(jax.devices()[:d]), ("data",)))
    for leaf in LEAVES:
        for s, (a, b) in enumerate(zip(getattr(t, leaf), getattr(js, leaf))):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (leaf, s)
            np.testing.assert_array_equal(a, b, err_msg=f"{leaf} {s}")
    assert t.slot_cnt == js.slot_cnt
    assert t.l_pad == js.l_pad
    for s in range(len(t.l_pad)):
        assert t.wedge_cnt[s] == tuple(
            int(k) for k in (np.asarray(js.sh_a_val[s]) != 0).sum(1))


def test_small_plan_leaves_a_rank_empty():
    _, _, _, args = _plans("empty_rank")
    t = shard_gtn_plan(tsparse.build_gtn_plan(*args, device="cpu"),
                       Mesh.layout(4))
    assert all(c[2] == 0 for c in t.slot_cnt)
    assert all(c[2] == 0 for c in t.wedge_cnt)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("stack", ["seed0", "seed1", "empty_rank"])
def test_sharded_plan_covers_all_wedges(d, stack):
    """Every real wedge lands in exactly one rank; the ranks' slots cover
    the output pattern; each rank's orders hold its wedges."""
    _, _, _, args = _plans(stack)
    plan = tsparse.build_gtn_plan(*args, device="cpu")
    t = shard_gtn_plan(plan, Mesh.layout(d))
    for s in range(len(plan.wedge_counts)):
        real = int((t.sh_a_val[s] != 0).sum())
        assert real == int((plan.step_a_val[s] != 0).sum())
        assert sum(t.slot_cnt[s]) == plan.nnz[s + 1]
        for k in range(d):
            fwd, bwd = t.orders(k, "cpu")
            assert fwd[s].graph.n_edges == t.wedge_cnt[s][k]
            assert bwd[s].graph.n_nodes == plan.nnz[s]
            assert fwd[s].graph.n_nodes == t.l_pad[s] * plan.n_types


def _jax_model(stack):
    adj, x, j, args = _plans(stack)
    model = jsparse.SparseGTN(num_classes=3, channels=2, num_layers=2,
                              hidden=8)
    params = model.init(jax.random.PRNGKey(0), j, jnp.asarray(x))["params"]

    def loss(p):
        out = model.apply({"params": p}, j, jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    state = {k: v.numpy() for k, v in
             from_flax(jax.tree.map(np.asarray, params)).items()}
    flat = {k: v.numpy() for k, v in
            from_flax(jax.tree.map(np.asarray, grads)).items()}
    kw = dict(in_features=x.shape[1], num_types=adj.shape[0], num_classes=3,
              channels=2, num_layers=2, hidden=8)
    return dict(out=np.asarray(out), grads=flat, state=state, kw=kw,
                args=args, x=x)


def _single(ref):
    m = tsparse.SparseGTN(**ref["kw"])
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in ref["state"].items()})
    out = m(tsparse.build_gtn_plan(*ref["args"], device="cpu"),
            torch.from_numpy(ref["x"]))
    (out ** 2).sum().backward()
    return out.detach().numpy(), {k: p.grad.numpy()
                                  for k, p in m.named_parameters()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    refs = {k: _jax_model(k) for k in ("seed0", "seed2", "empty_rank")}
    out = {}
    for d in WORLDS:
        cases = [(k, "sparse_gtn", dict(
            kw=r["kw"], state=r["state"], plan_args=r["args"], x=r["x"],
            blocked=257 if k == "seed2" else 0)) for k, r in refs.items()]
        if d == 4:
            r = refs["seed0"]
            cases.append(("seed0_2x2", "sparse_gtn", dict(
                kw=r["kw"], state=r["state"], plan_args=r["args"], x=r["x"],
                shape=(2, 2))))
        out[d] = torch_world.run_world(tmp_path_factory.mktemp(f"gtn{d}"),
                                       d, cases)
    return refs, out


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["out", "grads"])
def test_sharded_sparse_gtn_matches_single_device(worlds, d, key):
    """Every rank's logits and gradients equal JAX's single-device model's,
    with no step-level all-reduce (the psum of ``dh`` and ``d mix`` inside
    the composition's backward, the gather's own-slice backward)."""
    refs, res = worlds
    ref = refs["seed0"]
    for r in res[d]:
        got = r["seed0"]["unblocked"]
        if key == "out":
            np.testing.assert_allclose(got["out"], ref["out"], **FWD_TOL)
        else:
            assert sorted(got["grads"]) == sorted(ref["grads"])
            for k, g in ref["grads"].items():
                np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                           **GRAD_TOL)


@pytest.mark.parametrize("key", ["out", "grads"])
def test_sharded_sparse_gtn_on_the_data_axis_of_a_2x2_mesh(worlds, key):
    """The plan sharded over "data" of a 2×2 ("data", "model") mesh: two
    shards, each model column a copy, the collectives over the data axis
    alone; every rank's logits and gradients equal JAX's single-device
    model's."""
    refs, res = worlds
    ref = refs["seed0"]
    for r in res[4]:
        got = r["seed0_2x2"]
        assert len(got["slot_cnt"]) == 2
        got = got["unblocked"]
        if key == "out":
            np.testing.assert_allclose(got["out"], ref["out"], **FWD_TOL)
        else:
            for k, g in ref["grads"].items():
                np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                           **GRAD_TOL)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("key", ["out", "grads"])
def test_blocked_compose_matches_unblocked_on_a_sharded_plan(worlds, d, key):
    """``wedge_block=257`` streams every rank's ``fwd`` order in blocks of
    whole rows: the same logits and gradients as one K1 call."""
    _, res = worlds
    for r in res[d]:
        b, u = r["seed2"]["blocked"], r["seed2"]["unblocked"]
        if key == "out":
            np.testing.assert_allclose(b["out"], u["out"], **BLOCKED_TOL)
        else:
            for k, g in u["grads"].items():
                np.testing.assert_allclose(b["grads"][k], g, err_msg=k,
                                           **BLOCKED_TOL)


@pytest.mark.parametrize("d", WORLDS)
def test_plan_with_an_empty_rank_matches_single_device(worlds, d):
    """The plan that leaves rank 2 of 4 without slots or wedges: every
    rank's logits and gradients against JAX's and the port's
    single-device model."""
    refs, res = worlds
    ref = refs["empty_rank"]
    out, grads = _single(ref)
    for r in res[d]:
        got = r["empty_rank"]["unblocked"]
        np.testing.assert_allclose(got["out"], ref["out"], **FWD_TOL)
        np.testing.assert_allclose(got["out"], out, atol=1e-5, rtol=1e-5)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                       **GRAD_TOL)
            np.testing.assert_allclose(got["grads"][k], grads[k],
                                       err_msg=k, atol=1e-5, rtol=1e-5)
    if d == 4:
        assert res[d][2]["empty_rank"]["slot_cnt"][2] == 0
        assert all(w[2] == 0 for w in res[d][2]["empty_rank"]["wedges"])
