"""Tensor parallelism of the PyTorch port (``parallel/tp.py``,
``parallel/tp_models.py``), the sharded checkpoint backend
(``train/checkpoint.py``) and the scaling tool
(``tools/bench_scaling.py``) against the JAX package on the CPU.

A gloo world of 4 spawned processes (``torch_world.py``, only the port)
runs GCN, GAT, HAN (of one layer and of two, the second's input gathered
over "model") and the dense GTN on a 2×2 ("data" × "model") mesh,
the dense GTN on its stack's rows over 4 ranks and the DCP round trip; a
world of 2 runs the four families on a 1×2 mesh, the row-sharded GTN over
2 ranks and the scaling tool. JAX runs in the parent on conftest's virtual
devices under ``set_ops_impl("xla")``, as its own TP tests do, from the
same numpy inputs and flax parameters (``params.from_flax``).

Held: every rank's parameter slices equal to the shard JAX's GSPMD puts
on the device at the same mesh position (kernels transposed), exactly;
the loss and every gradient (slices reassembled over "model" after the
data all-reduce) against JAX's single-device values within JAX's own TP
tolerances (loss ``rtol=2e-5``, gradients ``rtol=3e-4, atol=3e-5``), and
against the port's single-device model within ``F32_TOL``; the model
ranks' replicated gradients equal without a model-axis all-reduce. The
rule engine's error paths mirror ``tests/test_tp_rules.py``, the
row-sharded GTN ``tests/test_parallel.py:test_gtn_gspmd_sharded_adjacency``
and the one-process DCP round trip ``tests/test_utils.py:
test_orbax_checkpoint_roundtrip``. Each world is spawned once for the
module; every case asserts in its own test.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core.graph import (  # noqa: E402
    add_self_loops, build_graph as j_build, sym_normalize_weights,
    symmetrize)
from graphneuralnetwork_tpu.data import (  # noqa: E402
    load_acm_gtn as j_load_gtn, load_acm_han as j_load_han)
from graphneuralnetwork_tpu.data.planetoid import (  # noqa: E402
    synthetic_citation_graph)
from graphneuralnetwork_tpu.nn import (  # noqa: E402
    GAT as JGAT, GCN as JGCN, GTN as JGTN, HAN as JHAN)
from graphneuralnetwork_tpu.ops import set_ops_impl  # noqa: E402
from graphneuralnetwork_tpu.parallel import (  # noqa: E402
    apply_tp as j_apply_tp, make_tp_mesh as j_make_tp_mesh,
    model_param_shardings as j_shardings)
from graphneuralnetwork_tpu_torch.core.graph import build_graph  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import GAT, GCN, HAN  # noqa: E402
from graphneuralnetwork_tpu_torch.nn.gtn import GTN  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel import Mesh  # noqa: E402
from graphneuralnetwork_tpu_torch.parallel.tp import (  # noqa: E402
    MODEL_RULES, ShardRule, apply_tp, gcn_rules, local_shard, make_tp_mesh,
    model_param_shardings, param_shardings, shard_rows)
from graphneuralnetwork_tpu_torch.parallel.tp_models import (  # noqa: E402
    _reshard_plan, tensor_parallel)
from graphneuralnetwork_tpu_torch.train import checkpoint  # noqa: E402
from graphneuralnetwork_tpu_torch.train.loop import TrainState  # noqa: E402
from graphneuralnetwork_tpu_torch.train.metrics import (  # noqa: E402
    masked_softmax_cross_entropy)

import torch_world  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_LOSS_TOL = dict(rtol=2e-5)
JAX_GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
#: world size -> the ("data", "model") shape its TP cases run on
SHAPES = {4: (2, 2), 2: (1, 2)}
FAMILIES = ("gcn", "gat", "han", "gtn")
#: the models the worlds run: each family, and HAN of two layers (its
#: second layer's input gathered over "model")
MODELS = FAMILIES + ("han2",)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALING_ARGV = ["--nodes-per-dev", "256", "--edges-per-dev", "2048",
                "--features", "8", "--devices", "1", "2"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_name(path) -> tuple:
    """(the port's name of a flax leaf, whether it is a kernel)."""
    keys = [str(getattr(p, "key", p)) for p in path]
    kernel = keys[-1] == "kernel"
    if kernel:
        keys[-1] = "weight"
    return ".".join(keys), kernel


def _citation():
    feats, labels, s, r = synthetic_citation_graph(
        n_nodes=256, n_feats=64, n_classes=4, seed=0)
    n = feats.shape[0]
    s, r = add_self_loops(*symmetrize(s, r), n)
    return dict(s=s, r=r, n=n, w=sym_normalize_weights(s, r, n), x=feats,
                labels=labels.astype(np.int64))


@pytest.fixture(scope="module")
def problems():
    """Each family's JAX model, parameters, single-device loss and
    gradients (XLA ops, as JAX's TP tests run), and the port's inputs."""
    out = {}
    c = _citation()
    n = c["n"]
    graph = j_build(c["s"], c["r"], n, c["w"])
    for fam, model, kw in (
            ("gcn", JGCN(hidden=16, num_classes=4, dropout=0.0),
             dict(in_features=64, hidden=16, num_classes=4, dropout=0.0)),
            ("gat", JGAT(hidden=8, num_heads=4, num_classes=4, dropout=0.0),
             dict(in_features=64, hidden=8, num_heads=4, num_classes=4,
                  dropout=0.0))):
        out[fam] = dict(
            model=model, args=(graph, jnp.asarray(c["x"])), kw=kw,
            rows=np.arange(n), labels=c["labels"],
            port=dict(s=c["s"], r=c["r"], w=c["w"] if fam == "gcn" else None,
                      x=c["x"], labels=c["labels"], idx=np.arange(n),
                      tiled=True))

    han = j_load_han(seed=0)
    edges = []
    for g in han.graphs:
        e = g.n_edges
        edges.append((np.asarray(g.senders)[:e], np.asarray(g.receivers)[:e],
                      None))
    x = np.asarray(han.features)
    for name, heads in (("han", (4,)), ("han2", (4, 4))):
        out[name] = dict(
            model=JHAN(num_metapaths=2, num_classes=3, hidden=8,
                       num_heads=heads),
            args=(han.graphs, han.features),
            kw=dict(in_features=x.shape[1], num_metapaths=2, num_classes=3,
                    hidden=8, num_heads=heads, dropout=0.0),
            rows=np.asarray(han.train_idx), labels=np.asarray(han.labels),
            port=dict(edges=edges, x=x, labels=np.asarray(
                han.labels).astype(np.int64), idx=np.asarray(han.train_idx)))

    gtn = j_load_gtn(seed=0)
    tgt, tr = np.asarray(gtn.target_idx), np.asarray(gtn.train_idx)
    lab = np.zeros(gtn.adj.shape[1], np.int64)
    lab[tgt] = np.asarray(gtn.labels)
    out["gtn"] = dict(
        model=JGTN(num_classes=3, channels=2, num_layers=2, hidden=16),
        args=(gtn.adj, gtn.features),
        kw=dict(in_features=gtn.features.shape[1],
                num_types=gtn.adj.shape[0], num_classes=3, channels=2,
                num_layers=2, hidden=16),
        rows=tgt[tr], labels=lab,
        port=dict(adj=np.asarray(gtn.adj), x=np.asarray(gtn.features),
                  labels=lab, idx=tgt[tr]))

    for name, p in out.items():
        p["family"] = "han" if name == "han2" else name
    set_ops_impl("xla")
    try:
        for fam, p in out.items():
            model = p["model"]
            params = model.init(jax.random.PRNGKey(0), *p["args"])["params"]
            rows, labels = jnp.asarray(p["rows"]), jnp.asarray(p["labels"])

            def loss_fn(prm, x, model=model, p=p, rows=rows, labels=labels):
                logits = model.apply({"params": prm}, p["args"][0], x)
                if isinstance(logits, tuple):
                    logits = logits[0]
                sel = logits[rows]
                return -jax.nn.log_softmax(sel)[
                    jnp.arange(sel.shape[0]), labels[rows]].mean()

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                params, jnp.asarray(p["args"][1]))
            p.update(params=params, loss=float(loss),
                     grads={k: v.numpy() for k, v in
                            from_flax(_np(grads)).items()},
                     state={k: v.numpy() for k, v in
                            from_flax(_np(params)).items()})
    finally:
        set_ops_impl("auto")
    return out


def _jax_shards(p, shape) -> dict:
    """{(d, m): {port name: the shard GSPMD puts on the device at mesh
    position (d, m)}}, kernels transposed."""
    d_n, m_n = shape
    mesh = j_make_tp_mesh(d_n, m_n, devices=jax.devices()[:d_n * m_n])
    p_tp = j_apply_tp(p["params"], j_shardings(mesh, p["params"],
                                               p["family"]))
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(p_tp)
    for d in range(d_n):
        for m in range(m_n):
            dev = mesh.devices[d, m]
            leaves = {}
            for path, leaf in flat:
                name, kernel = _port_name(path)
                shard = next(s for s in leaf.addressable_shards
                             if s.device == dev)
                a = np.asarray(shard.data)
                leaves[name] = np.ascontiguousarray(a.T) if kernel else a
            out[(d, m)] = leaves
    return out


def _rows_gtn():
    """``test_gtn_gspmd_sharded_adjacency``'s stack: 3 random types over
    64 nodes, 16 features."""
    rng = np.random.default_rng(42)
    n, t, f_in = 64, 3, 16
    adj = (rng.random((t, n, n)) < 0.1).astype(np.float32)
    x = rng.normal(size=(n, f_in)).astype(np.float32)
    model = JGTN(num_classes=3, channels=2, num_layers=2, hidden=8)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(adj),
                        jnp.asarray(x))["params"]

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(adj), jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(adj=adj, x=x, out=np.asarray(out),
                grads={k: v.numpy() for k, v in from_flax(_np(grads)).items()},
                state={k: v.numpy() for k, v in
                       from_flax(_np(params)).items()},
                kw=dict(in_features=f_in, num_types=t, num_classes=3,
                        channels=2, num_layers=2, hidden=8))


def _jax_scaling(argv, capsys_out) -> dict:
    spec = importlib.util.spec_from_file_location(
        "j_bench_scaling", os.path.join(ROOT, "tools", "bench_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)
    return json.loads(capsys_out().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def worlds(problems, tmp_path_factory):
    """For each world: (JAX's shards per family, the ranks' results)."""
    gr = _rows_gtn()
    out = {}
    for world, shape in SHAPES.items():
        cases, shards = [], {}
        for fam in MODELS:
            p = problems[fam]
            shards[fam] = _jax_shards(p, shape)
            cases.append((fam, "tp", dict(family=p["family"], shape=shape,
                                          kw=p["kw"], state=p["state"],
                                          **p["port"])))
        cases.append(("gtn_rows", "gtn_rows", dict(
            kw=gr["kw"], state=gr["state"], adj=gr["adj"], x=gr["x"])))
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        if world == 4:
            c = _citation()
            cases.append(("dcp", "dcp", dict(
                tmp=str(tmp / "ckpt"), shape=shape,
                kw=problems["gcn"]["kw"], state=problems["gcn"]["state"],
                x=c["x"], labels=c["labels"], idx=np.arange(0, 100),
                s=c["s"], r=c["r"], w=c["w"])))
        else:
            for graph in ("clustered", "shuffled"):
                cases.append((f"scaling_{graph}", "bench_scaling", dict(
                    argv=SCALING_ARGV + ["--graph", graph, "--device",
                                         "cpu"])))
        out[world] = (shards, torch_world.run_world(tmp, world, cases))
    return gr, out


# ---------------------------------------------------------------------------
# the rule engine, in one process
# ---------------------------------------------------------------------------


def _one():
    return make_tp_mesh(1, 1, device="cpu")


def test_unmatched_param_raises():
    """A param no rule covers must error, not silently replicate."""
    params = {"conv1.linear.weight": torch.zeros(4, 4),
              "mystery.weight": torch.zeros(4, 4)}
    with pytest.raises(ValueError, match="no sharding rule matches"):
        param_shardings(_one(), params, gcn_rules())


def test_rule_rank_mismatch_raises():
    with pytest.raises(ValueError, match="more axes"):
        param_shardings(_one(), {"w": torch.zeros(4)},
                        [ShardRule(r"w", (None, "model"))])


def test_explicit_replicate_tail_rule():
    params = {"a": torch.zeros(4, 4), "b": torch.zeros(2)}
    sh = param_shardings(_one(), params, [ShardRule(r".*", ())])
    assert all(spec == () for spec in sh.values())


def test_uneven_slice_raises():
    """A dimension that does not split over the model axis raises, as
    JAX's ``device_put`` of the sharding does; GAT's heads must divide."""
    with pytest.raises(ValueError, match="does not split evenly"):
        local_shard(torch.zeros(3, 4), ("model", None), {"model": 2},
                    {"model": 0})
    gat = GAT(8, hidden=4, num_heads=3, num_classes=2, dropout=0.0)
    mesh = Mesh(np.arange(2).reshape(1, 2), ("data", "model"), None,
                torch.device("cpu"), 1)
    with pytest.raises(ValueError, match="does not split evenly"):
        apply_tp(gat, model_param_shardings(mesh, gat, "gat"), mesh)


@pytest.mark.parametrize("fam", FAMILIES)
def test_every_port_parameter_matches_a_rule(problems, fam):
    """Each family's rules cover every parameter of the port's model, and
    name the same leaves as JAX's rules shard."""
    p = problems[fam]
    specs = model_param_shardings(_one(), p["state"], p["family"])
    assert sorted(specs) == sorted(p["state"])
    assert set(MODEL_RULES) == set(FAMILIES)


def test_dropout_raises_in_training():
    m = GCN(8, hidden=4, num_classes=2, dropout=0.5)
    with pytest.raises(ValueError, match="without dropout"):
        tensor_parallel(m, _one(), "gcn")
    tp = tensor_parallel(m.eval(), _one(), "gcn")
    with pytest.raises(ValueError, match="without dropout"):
        tp.train()


@pytest.mark.parametrize("channels,hidden,m", [(2, 16, 2), (3, 4, 2),
                                               (2, 8, 4), (1, 6, 3)])
def test_linear1_reshard_plan(channels, hidden, m):
    """The all-to-all that turns each model rank's hidden slice of every
    channel into the rule's contiguous block of linear1's rows, on the host:
    every block column comes from the rank that holds it."""
    send, recv, slab = _reshard_plan(channels, hidden, m)
    k, block = hidden // m, channels * hidden // m
    z = np.arange(channels * hidden).reshape(channels, hidden)  # the concat
    held = [z[:, r * k:(r + 1) * k].reshape(-1) for r in range(m)]
    for b in range(m):
        got_slab = np.concatenate([held[r][send[r, b]] for r in range(m)])
        assert got_slab.shape == (m * slab,)
        np.testing.assert_array_equal(got_slab[recv[b]],
                                      z.reshape(-1)[b * block:
                                                    (b + 1) * block])


def test_shard_rows_pads_to_divide():
    mesh = Mesh(np.arange(3).reshape(3, 1), ("data", "model"), None,
                torch.device("cpu"), 2)
    x = np.arange(10 * 2).reshape(10, 2)
    got = shard_rows(x, mesh)
    np.testing.assert_array_equal(got.numpy(), [[16, 17], [18, 19], [0, 0],
                                                [0, 0]])


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------


def _specs(p, shape) -> dict:
    return model_param_shardings(Mesh.layout(shape, ("data", "model")),
                                 p["state"], p["family"])


def _assemble(res, fam, key, p, shape) -> dict:
    """The whole of each parameter's ``key`` (gradients) from the data rank
    0's model ranks."""
    d_n, m_n = shape
    specs = _specs(p, shape)
    by = {tuple(r[fam]["coords"]): r[fam][key] for r in res}
    out = {}
    for name, spec in specs.items():
        parts = [by[(0, m)][name] for m in range(m_n)]
        dim = spec.index("model") if "model" in spec else None
        out[name] = parts[0] if dim is None else np.concatenate(parts, dim)
    return out


@pytest.mark.parametrize("world", sorted(SHAPES))
@pytest.mark.parametrize("fam", MODELS)
def test_shards_equal_jax(worlds, fam, world):
    """Rank (d, m)'s slice of every parameter is the shard JAX's GSPMD
    places on the device at mesh position (d, m)."""
    shards, res = worlds[1][world]
    for r in res:
        got = r[fam]["shards"]
        want = shards[fam][tuple(r[fam]["coords"])]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("world", sorted(SHAPES))
@pytest.mark.parametrize("fam", MODELS)
@pytest.mark.parametrize("key", ["loss", "grads"])
def test_tp_step_matches_jax_single_device(problems, worlds, fam, world,
                                           key):
    p = problems[fam]
    res = worlds[1][world][1]
    if key == "loss":
        for r in res:
            np.testing.assert_allclose(r[fam]["loss"], p["loss"],
                                       **JAX_LOSS_TOL)
        return
    got = _assemble(res, fam, "grads", p, SHAPES[world])
    assert sorted(got) == sorted(p["grads"])
    for k, g in p["grads"].items():
        np.testing.assert_allclose(got[k], g, err_msg=k, **JAX_GRAD_TOL)


def _port_single(p):
    """The port's single-device model: (logits, loss, gradients)."""
    fam = p["family"]
    make = {"gcn": GCN, "gat": GAT, "han": HAN, "gtn": GTN}[fam]
    m = make(**p["kw"])
    m.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()})
    m.eval()
    q = p["port"]
    x = torch.from_numpy(q["x"])
    if fam == "gtn":
        logits = m(torch.from_numpy(q["adj"]), x)
    elif fam == "han":
        logits = m([build_graph(s, r, x.shape[0], device="cpu")
                    for s, r, _ in q["edges"]], x)
    else:
        logits = m(build_graph(q["s"], q["r"], x.shape[0], q["w"],
                               device="cpu"), x)
    idx = torch.from_numpy(q["idx"])
    loss = masked_softmax_cross_entropy(
        logits[idx], torch.from_numpy(q["labels"])[idx])
    loss.backward()
    return (logits.detach().numpy(), float(loss.detach()),
            {k: v.grad.numpy() for k, v in m.named_parameters()})


@pytest.mark.parametrize("world", sorted(SHAPES))
@pytest.mark.parametrize("fam", MODELS)
@pytest.mark.parametrize("key", ["logits", "loss", "grads"])
def test_tp_step_matches_port_single_device(problems, worlds, fam, world,
                                            key):
    p = problems[fam]
    res = worlds[1][world][1]
    logits, loss, grads = _port_single(p)
    d_n = SHAPES[world][0]
    if key == "logits":
        by = {tuple(r[fam]["coords"]): r[fam]["logits"] for r in res}
        for m in range(SHAPES[world][1]):
            got = np.concatenate([by[(d, m)] for d in range(d_n)])
            np.testing.assert_allclose(got[:logits.shape[0]], logits,
                                       **F32_TOL)
    elif key == "loss":
        for r in res:
            np.testing.assert_allclose(r[fam]["loss"], loss, **F32_TOL)
    else:
        got = _assemble(res, fam, "grads", p, SHAPES[world])
        for k, g in grads.items():
            np.testing.assert_allclose(got[k], g, err_msg=k, **F32_TOL)


@pytest.mark.parametrize("world", sorted(SHAPES))
@pytest.mark.parametrize("fam", MODELS)
def test_gradients_agree_across_ranks_without_a_model_all_reduce(
        problems, worlds, fam, world):
    """After the data all-reduce alone, every data rank holds the same
    slices, and the model ranks the same replicated gradients (the
    convention of ``tp.py``'s docstring)."""
    res = worlds[1][world][1]
    specs = _specs(problems[fam], SHAPES[world])
    by = {tuple(r[fam]["coords"]): r[fam]["grads"] for r in res}
    for (d, m), grads in by.items():
        for k, spec in specs.items():
            same = by[(0, m)] if "model" in spec else by[(0, 0)]
            np.testing.assert_allclose(grads[k], same[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("world", sorted(SHAPES))
@pytest.mark.parametrize("key", ["out", "grads"])
def test_gtn_on_row_sharded_stack_matches_jax(worlds, world, key):
    """The dense GTN with its stack's rows split over the ranks: forward
    (JAX's test's tolerance) and the gradients of the sum of squared
    logits, against JAX's single-device model and the port's."""
    gr, out = worlds
    res = out[world][1]
    m = GTN(**gr["kw"])
    m.load_state_dict({k: torch.from_numpy(v) for k, v in gr["state"].items()})
    logits = m(torch.from_numpy(gr["adj"]), torch.from_numpy(gr["x"]))
    (logits ** 2).sum().backward()
    n = gr["out"].shape[0]
    if key == "out":
        got = np.concatenate([r["gtn_rows"]["out"] for r in res])[:n]
        np.testing.assert_allclose(got, gr["out"], atol=2e-4, rtol=1e-3)
        np.testing.assert_allclose(got, logits.detach().numpy(), **F32_TOL)
        return
    for r in res:
        for k, g in gr["grads"].items():
            np.testing.assert_allclose(r["gtn_rows"]["grads"][k], g,
                                       err_msg=k, **JAX_GRAD_TOL)
        for k, p in m.named_parameters():
            np.testing.assert_allclose(r["gtn_rows"]["grads"][k],
                                       p.grad.numpy(), err_msg=k, **F32_TOL)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_dcp_round_trip_on_the_2x2_world(worlds):
    """Save with the sharded backend on the 2×2 world (each rank its own
    file), restore into blank slices: parameters and Adam moments equal,
    ``latest_step``; a single-file save after it is detected as the last
    backend."""
    for r in worlds[1][4][1]:
        got = r["dcp"]
        assert got["step"] == 5 and got["latest"] == 5
        assert got["same_params"] and got["same_moments"]
        assert got["backend"] == "dcp"
        assert got["files"] == [".metadata"] + [f"__{k}_0.distcp"
                                                for k in range(4)]
        assert got["backend_after_file"] == "file"
        assert got["latest_after_file"] == 6


class _W(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(w)


def _state(w):
    m = _W(w)
    return TrainState(m, torch.optim.Adam(m.parameters(), lr=1e-2), None,
                      torch.Generator())


def test_dcp_checkpoint_roundtrip_one_process(tmp_path):
    """``test_orbax_checkpoint_roundtrip`` in one process: the sharded
    backend writes and restores without a process group."""
    st = _state(torch.arange(6.0).reshape(2, 3))
    st.model.w.grad = torch.ones(2, 3)
    st.optimizer.step()
    checkpoint.save_checkpoint(str(tmp_path), st, step=7, backend="dcp")
    blank = _state(torch.zeros(2, 3))
    restored, step = checkpoint.restore_checkpoint(str(tmp_path), blank)
    assert step == 7
    np.testing.assert_allclose(restored.model.w.detach().numpy(),
                               st.model.w.detach().numpy())
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(restored.optimizer.state[restored.model.w][k],
                           st.optimizer.state[st.model.w][k]), k


def test_restore_reads_the_backend_that_wrote_last(tmp_path):
    d = str(tmp_path)
    st = _state(torch.ones(3))
    assert checkpoint.last_backend(d) is None
    assert checkpoint.latest_step(d) is None
    checkpoint.save_checkpoint(d, st, 1)
    assert checkpoint.last_backend(d) == "file"
    with torch.no_grad():
        st.model.w.fill_(2.0)
    checkpoint.save_checkpoint(d, st, 2, backend="dcp")
    assert (checkpoint.last_backend(d), checkpoint.latest_step(d)) == (
        "dcp", 2)
    blank = _state(torch.zeros(3))
    assert checkpoint.restore_checkpoint(d, blank)[1] == 2
    assert float(blank.model.w[0]) == 2.0
    with torch.no_grad():
        st.model.w.fill_(3.0)
    checkpoint.save_checkpoint(d, st, 3)
    assert (checkpoint.last_backend(d), checkpoint.latest_step(d)) == (
        "file", 3)
    blank = _state(torch.zeros(3))
    assert checkpoint.restore_checkpoint(d, blank)[1] == 3
    assert float(blank.model.w[0]) == 3.0
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        checkpoint.save_checkpoint(d, st, 4, backend="orbax")


# ---------------------------------------------------------------------------
# the scaling tool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["clustered", "shuffled"])
def test_bench_scaling_matches_jax_tool(worlds, graph, capsys):
    """``bench_scaling.py`` on a gloo world of 2: its halo statistics equal
    what the repo's JAX tool computes on two virtual devices from the same
    inputs, and its records carry JAX's keys (``platform`` in place of
    ``cpu_virtual_mesh``)."""
    want = _jax_scaling(SCALING_ARGV + ["--graph", graph],
                        lambda: capsys.readouterr().out)
    res = worlds[1][2][1]
    for r in res:
        got = r[f"scaling_{graph}"]
        assert set(got) == (set(want) - {"cpu_virtual_mesh"}) | {"platform"}
        assert got["platform"] == "gloo"
        assert got["metric"] == want["metric"]
        for g, w in zip(got["detail"], want["detail"]):
            assert set(g) == set(w)
            for k in ("boundary_edge_frac", "halo_rows_per_device",
                      "local_rows_per_device", "halo_to_local_ratio",
                      "devices"):
                assert g.get(k) == w.get(k), k
    primary = res[0][f"scaling_{graph}"]["detail"]
    assert all(rec["edges_per_s"] > 0 for rec in primary)
