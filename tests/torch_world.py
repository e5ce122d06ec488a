"""One rank of a gloo world that runs the PyTorch port's parallel cases on
the CPU, for ``tests/test_torch_parallel.py``, ``test_torch_halo.py``,
``test_torch_multihost.py``, ``test_torch_tp.py`` and
``test_torch_gtn_sharded.py``.

    python tests/torch_world.py JOB RANK

``JOB`` is a pickle that the test wrote: the world size, the rendezvous
file, and a list of ``(name, case, kwargs)`` with numpy inputs. Each rank
runs every case in order and writes ``{JOB}.{RANK}`` (a pickle of
``{name: {key: numpy array or value}}``). This module imports only the
port, never JAX; ``run_world`` (imported by the tests) starts the ranks and
collects their results.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: Seconds a collective waits for its peers, and a whole world may run.
COLLECTIVE_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 240


def run_world(tmp_path: Path, world: int, cases: list) -> list[dict]:
    """Run ``cases`` on a gloo world of ``world`` processes; returns each
    rank's results. Fails (and kills the ranks) past ``WORLD_TIMEOUT_S``."""
    job = tmp_path / f"world{world}.pkl"
    with open(job, "wb") as f:
        pickle.dump({"world": world, "init": f"file://{tmp_path}/rdv{world}",
                     "cases": cases}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS")}
    env.update(PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), str(job), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(logs))
    results = []
    for r in range(world):
        with open(f"{job}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the cases (run inside the ranks)
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy()


def _module(make, state):
    import torch

    m = make()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m


def _grads(module):
    return {k: _np(p.grad) for k, p in module.named_parameters()
            if p.grad is not None}


def case_spmm(mesh, s, r, n, w, x, kind="halo", tiled=False,
              min_edges=192, op="spmm"):
    """This rank's rows of ``spmm`` (or ``segment_max``) on a halo or
    sharded partition, and the gradient of ``Σ tanh(out)`` over the real
    rows with respect to its rows of ``x``."""
    import torch

    from graphneuralnetwork_tpu_torch.ops.spmm import spmm
    from graphneuralnetwork_tpu_torch.parallel import (
        partition_graph, partition_graph_halo, segment_max_halo,
        shard_nodes, shard_nodes_halo)

    if kind == "halo":
        g = partition_graph_halo(s, r, n, w, mesh=mesh, tiled_interior=tiled,
                                 min_edges_per_tile=min_edges)
        xl = shard_nodes_halo(x, g)
        mask = g.local.row_mask
    else:
        g = partition_graph(s, r, n, w, mesh=mesh)
        xl = shard_nodes(x, g)
        nps = g.nodes_per_shard
        mask = mesh.rank * nps + torch.arange(nps) < n
    xl.requires_grad_(True)
    out = spmm(g, xl) if op == "spmm" else segment_max_halo(g, xl)
    torch.tanh(out)[mask].sum().backward()
    return {"out": _np(out), "grad": _np(xl.grad)}


def case_gat_halo(mesh, s, r, n, x, w, a_src, a_dst):
    """``gat_halo``'s rows and the gradient of the mean of ``out²`` over the
    real rows with respect to ``w`` (summed over the ranks) and to this
    rank's ``x``."""
    import torch

    from graphneuralnetwork_tpu_torch.parallel import (
        gat_halo, partition_graph_halo, shard_nodes_halo)
    from graphneuralnetwork_tpu_torch.parallel.collectives import (
        all_reduce_gradients)

    hg = partition_graph_halo(s, r, n, mesh=mesh)
    xl = shard_nodes_halo(x, hg).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = gat_halo(hg, xl, wt, torch.from_numpy(a_src),
                   torch.from_numpy(a_dst))
    ((out[hg.local.row_mask] ** 2).sum() / (n * out.shape[1])).backward()
    all_reduce_gradients([wt], mesh)
    return {"out": _np(out), "grad_w": _np(wt.grad), "grad_x": _np(xl.grad)}


def case_gat_attend(mesh, s, r, n, h, fs, fd, c, tiled=True, min_edges=16):
    """``gat_halo_attend``'s rows on a (tiled) partition and the gradients
    of ``Σ out · c`` with respect to this rank's ``h``, ``f_src``,
    ``f_dst``."""
    from graphneuralnetwork_tpu_torch.parallel import (
        gat_halo_attend, partition_graph_halo, shard_nodes_halo)

    hg = partition_graph_halo(s, r, n, mesh=mesh, tiled_interior=tiled,
                              min_edges_per_tile=min_edges)
    heads, feat = h.shape[1], h.shape[2]
    hl = shard_nodes_halo(h.reshape(n, -1), hg).reshape(
        -1, heads, feat).requires_grad_(True)
    fsl = shard_nodes_halo(fs, hg).requires_grad_(True)
    fdl = shard_nodes_halo(fd, hg).requires_grad_(True)
    cl = shard_nodes_halo(c, hg)
    out = gat_halo_attend(hg, hl, fsl, fdl)
    (out * cl).sum().backward()
    return {"out": _np(out), "grad_h": _np(hl.grad), "grad_fs": _np(fsl.grad),
            "grad_fd": _np(fdl.grad), "tiles": hg.local.tiles is not None}


def case_conv(mesh, s, r, n, x, state, layer, kw, seed=0, dropout_runs=0):
    """A ``GATConv`` or ``SAGEConv`` on the halo partition with the given
    parameters: its rows, the gradients of the mean of ``out²`` (real
    rows) with respect to this rank's ``x`` and to the parameters (summed
    over the ranks); with ``dropout_runs``, that many training-mode forwards with
    this rank's generator, and the kept share of their attention draws."""
    import torch

    from graphneuralnetwork_tpu_torch.nn import conv
    from graphneuralnetwork_tpu_torch.parallel import (
        halo_attention, partition_graph_halo, shard_nodes_halo)
    from graphneuralnetwork_tpu_torch.parallel.collectives import (
        all_reduce_gradients)

    hg = partition_graph_halo(s, r, n, mesh=mesh)
    m = _module(lambda: getattr(conv, layer)(x.shape[1], **kw), state)
    m.eval()
    xl = shard_nodes_halo(x, hg).requires_grad_(True)
    out = m(hg, xl)
    ((out[hg.local.row_mask] ** 2).sum() / (n * out.shape[1])).backward()
    all_reduce_gradients(m.parameters(), mesh)
    res = {"out": _np(out), "grad_x": _np(xl.grad), "grads": _grads(m)}
    if dropout_runs:
        kept, drawn = [0], [0]
        drop = halo_attention._drop

        def counting(e, keep, generator):
            out = drop(e, keep, generator)
            kept[0] += int((out != 0).sum())
            drawn[0] += int((e != 0).sum())
            return out

        halo_attention._drop = counting
        try:
            m.train()
            gen = halo_attention.rank_generator(seed, mesh.rank, "cpu")
            with torch.no_grad():
                res["dropped"] = [_np(m(hg, xl, generator=gen))
                                  for _ in range(dropout_runs)]
        finally:
            halo_attention._drop = drop
        res["kept_share"] = kept[0] / max(drawn[0], 1)
    return res


def case_han(mesh, edges, n, x, state, kw, labels, idx):
    """HAN on halo-partitioned metapath graphs: this rank's logits, the
    loss over ``idx`` (its share, summed over the ranks) and the
    parameters' gradients (summed over the ranks)."""
    import torch

    from graphneuralnetwork_tpu_torch.nn import HAN
    from graphneuralnetwork_tpu_torch.parallel import (
        partition_graph_halo, shard_nodes_halo)
    from graphneuralnetwork_tpu_torch.parallel.collectives import (
        all_reduce_gradients, all_reduce_sum)
    from graphneuralnetwork_tpu_torch.parallel.dp import (
        dp_cross_entropy, owned_rows)

    hgs = [partition_graph_halo(s, r, n, mesh=mesh) for s, r in edges]
    m = _module(lambda: HAN(x.shape[1], **kw), state)
    m.eval()
    xl = shard_nodes_halo(x, hgs[0])
    logits = m(hgs, xl)
    nps = hgs[0].nodes_per_shard
    y = shard_nodes_halo(labels, hgs[0]).long()
    loss = dp_cross_entropy(logits, y, owned_rows(
        torch.from_numpy(idx), mesh.rank, nps), mesh)
    loss.backward()
    all_reduce_gradients(m.parameters(), mesh)
    return {"logits": _np(logits), "grads": _grads(m),
            "loss": float(all_reduce_sum(loss.detach(), mesh))}


def case_gcn_step(mesh, s, r, n, w, x, labels, idx, state, hidden, kind,
                  lr=1e-2, tiled=False, min_edges=192):
    """One data-parallel GCN step (dropout 0) on a sharded or halo
    partition: the loss, its parameters' gradients (summed over the
    ranks), the logits, and the loss after one Adam step (optax's
    defaults)."""
    import torch

    from graphneuralnetwork_tpu_torch.nn import GCN
    from graphneuralnetwork_tpu_torch.parallel import (
        partition_graph, partition_graph_halo, shard_nodes, shard_nodes_halo)
    from graphneuralnetwork_tpu_torch.parallel.dp import (
        dp_cross_entropy, dp_step, owned_rows)

    if kind == "halo":
        g = partition_graph_halo(s, r, n, w, mesh=mesh, tiled_interior=tiled,
                                 min_edges_per_tile=min_edges)
        xl, y = shard_nodes_halo(x, g), shard_nodes_halo(labels, g).long()
    else:
        g = partition_graph(s, r, n, w, mesh=mesh)
        xl, y = shard_nodes(x, g), shard_nodes(labels, g).long()
    m = _module(lambda: GCN(x.shape[1], hidden=hidden,
                            num_classes=int(labels.max()) + 1, dropout=0.0),
                state)
    rows = owned_rows(torch.from_numpy(idx), mesh.rank, g.nodes_per_shard)
    opt = torch.optim.Adam(m.parameters(), lr=lr, eps=1e-8)
    out = {}

    def local_loss():
        logits = m(g, xl)
        out.setdefault("logits", _np(logits))   # the first step's
        return dp_cross_entropy(logits, y, rows, mesh)

    loss = dp_step(m.parameters(), opt, local_loss, mesh)
    out["grads"] = _grads(m)
    out["loss"] = float(loss)
    loss2 = dp_step(m.parameters(), opt, local_loss, mesh)
    out["loss_after_step"] = float(loss2)
    return out


def case_skipgram(mesh, vocab, dim, centers, ctx_neg, labels, mask, state,
                  lr=1e-2):
    """One data-parallel skip-gram step on this rank's block of the
    batch: the batch's loss and accuracy and the tables after the step."""
    import torch

    from graphneuralnetwork_tpu_torch.nn.embed import SkipGram
    from graphneuralnetwork_tpu_torch.train.embed_loop import (
        make_adam, make_skipgram_step, shard_batch_arrays)

    m = _module(lambda: SkipGram(vocab, dim), state)
    step = make_skipgram_step(m, make_adam(m.parameters(), lr,
                                           torch.device("cpu")), mesh=mesh)
    batch = shard_batch_arrays((centers, ctx_neg, labels, mask), mesh)
    loss, acc = step(*batch)
    return {"loss": float(loss), "acc": float(acc),
            "state": {k: _np(v) for k, v in m.state_dict().items()}}


def case_dryrun(mesh, width="tiny"):
    """The port's multi-device dry run on the CPU (every phase checks its
    step against the single-device model): each phase's report."""
    from graphneuralnetwork_tpu_torch.parallel.dryrun import dryrun_multichip

    reports = dryrun_multichip(mesh, width=width)
    for rep in reports.values():
        rep.pop("step")
    return reports


def _tp_model(family, kw, state):
    from graphneuralnetwork_tpu_torch.nn import GAT, GCN, HAN
    from graphneuralnetwork_tpu_torch.nn.gtn import GTN

    make = {"gcn": GCN, "gat": GAT, "han": HAN, "gtn": GTN}[family]
    m = _module(lambda: make(**kw), state)
    m.eval()
    return m


def case_tp(mesh, family, shape, kw, state, x, labels, idx, s=None, r=None,
            w=None, edges=None, adj=None, tiled=False):
    """One dp x tp step of ``family`` on a ``shape`` ("data", "model") mesh
    (dropout off): this rank's mesh coordinates, its parameter slices,
    their gradients (summed over the data sub-mesh), its rows' logits, and
    the loss (every data rank's share summed), the mean cross-entropy over
    the global rows ``idx``."""
    import torch

    from graphneuralnetwork_tpu_torch.parallel import (
        partition_graph_halo, shard_nodes_halo)
    from graphneuralnetwork_tpu_torch.parallel.collectives import (
        all_reduce_gradients, all_reduce_sum)
    from graphneuralnetwork_tpu_torch.parallel.dp import (
        dp_cross_entropy, owned_rows)
    from graphneuralnetwork_tpu_torch.parallel.tp import (
        make_tp_mesh, shard_rows)
    from graphneuralnetwork_tpu_torch.parallel.tp_models import (
        gtn_rows, tensor_parallel)

    tpm = make_tp_mesh(*shape, device="cpu")
    dm = tpm.axis("data")
    tp = tensor_parallel(_tp_model(family, kw, state), tpm, family)
    n = x.shape[0]
    if family == "gtn":
        a, xl = gtn_rows(adj, x, dm)
        logits, y = tp(a, xl), shard_rows(labels, dm)
        nps = a.shape[1]
    else:
        graphs = [partition_graph_halo(
            s2, r2, n, w2, mesh=dm, tiled_interior=tiled,
            min_edges_per_tile=8)
            for s2, r2, w2 in (edges or [(s, r, w)])]
        xl, y = shard_nodes_halo(x, graphs[0]), shard_nodes_halo(labels,
                                                                 graphs[0])
        logits = tp(graphs if family == "han" else graphs[0], xl)
        nps = graphs[0].nodes_per_shard
    rows = owned_rows(torch.from_numpy(idx), dm.rank, nps)
    loss = dp_cross_entropy(logits, y.long(), rows, dm)
    loss.backward()
    all_reduce_gradients(tp.parameters(), dm)
    return {"coords": tpm.coords, "logits": _np(logits),
            "shards": {k: _np(v) for k, v in tp.state_dict().items()},
            "grads": _grads(tp),
            "loss": float(all_reduce_sum(loss.detach(), dm))}


def case_gtn_rows(mesh, kw, state, adj, x):
    """The dense GTN on this rank's rows of the stack (a 1-D mesh): its
    rows' logits and the gradients of the sum of the logits' squares over
    the real rows (summed over the ranks)."""
    from graphneuralnetwork_tpu_torch.parallel.collectives import (
        all_reduce_gradients)
    from graphneuralnetwork_tpu_torch.parallel.tp_models import (
        TPGTN, gtn_rows)

    tp = TPGTN(_tp_model("gtn", kw, state), mesh)
    a, xl = gtn_rows(adj, x, mesh)
    out = tp(a, xl)
    nl, n = a.shape[1], x.shape[0]
    real = max(0, min(nl, n - mesh.rank * nl))
    (out[:real] ** 2).sum().backward()
    all_reduce_gradients(tp.parameters(), mesh)
    return {"out": _np(out), "grads": _grads(tp)}


def case_dcp(mesh, tmp, shape, kw, state, x, labels, idx, s, r, w):
    """A dp x tp GCN after one Adam step saved with the sharded backend,
    restored into a blank model and optimizer: whether every slice and
    moment came back, ``latest_step``, and the backend detected after a
    single-file save over it."""
    import torch

    from graphneuralnetwork_tpu_torch.parallel import (
        partition_graph_halo, shard_nodes_halo)
    from graphneuralnetwork_tpu_torch.parallel.dp import (
        dp_cross_entropy, owned_rows)
    from graphneuralnetwork_tpu_torch.parallel.tp import make_tp_mesh
    from graphneuralnetwork_tpu_torch.parallel.tp_models import (
        tensor_parallel, tp_step)
    from graphneuralnetwork_tpu_torch.train import checkpoint
    from graphneuralnetwork_tpu_torch.train.loop import TrainState

    tpm = make_tp_mesh(*shape, device="cpu")
    dm = tpm.axis("data")
    tp = tensor_parallel(_tp_model("gcn", kw, state), tpm, "gcn")
    hg = partition_graph_halo(s, r, x.shape[0], w, mesh=dm)
    xl, y = shard_nodes_halo(x, hg), shard_nodes_halo(labels, hg).long()
    rows = owned_rows(torch.from_numpy(idx), dm.rank, hg.nodes_per_shard)
    opt = torch.optim.Adam(tp.parameters(), lr=1e-2)
    tp_step(tp, opt, lambda: dp_cross_entropy(tp(hg, xl), y, rows, dm))
    st = TrainState(tp, opt, None, torch.Generator())
    path = checkpoint.save_checkpoint(tmp, st, 5, backend="dcp")

    blank = tensor_parallel(_tp_model("gcn", kw, state), tpm, "gcn")
    with torch.no_grad():
        for p in blank.parameters():
            p.zero_()
    opt2 = torch.optim.Adam(blank.parameters(), lr=1e-2)
    st2, step = checkpoint.restore_checkpoint(tmp, TrainState(
        blank, opt2, None, torch.Generator()))
    same = all(torch.equal(a, b) for a, b in zip(tp.parameters(),
                                                 blank.parameters()))
    moments = all(
        torch.equal(opt.state[a][k], opt2.state[b][k])
        for a, b in zip(tp.parameters(), blank.parameters())
        for k in ("exp_avg", "exp_avg_sq", "step"))
    res = {"path": path, "step": step, "same_params": same,
           "same_moments": moments, "latest": checkpoint.latest_step(tmp),
           "backend": checkpoint.last_backend(tmp),
           "files": sorted(os.listdir(path))}
    import torch.distributed as dist
    dist.barrier()
    checkpoint.save_checkpoint(tmp, st, 6)
    dist.barrier()
    res["backend_after_file"] = checkpoint.last_backend(tmp)
    res["latest_after_file"] = checkpoint.latest_step(tmp)
    return res


def case_sparse_gtn(mesh, kw, state, plan_args, x, blocked=0, shape=None):
    """The wedge-plan GTN on a plan sharded over the ranks: the logits and
    the gradients of the sum of their squares, on every rank, with no
    all-reduce after the backward; with ``blocked``, also the logits and
    gradients at ``wedge_block=blocked``. With ``shape``, the plan is
    sharded over the "data" axis of a ("data", "model") mesh of that
    shape, each model column holding a copy."""
    import torch

    from graphneuralnetwork_tpu_torch.nn.gtn_sparse import (
        SparseGTN, build_gtn_plan)
    from graphneuralnetwork_tpu_torch.parallel.gtn_sparse import (
        shard_gtn_plan)
    from graphneuralnetwork_tpu_torch.parallel.tp import make_tp_mesh

    if shape is not None:
        mesh = make_tp_mesh(*shape, device="cpu")
    splan = shard_gtn_plan(build_gtn_plan(*plan_args, device="cpu"), mesh)
    res = {"slot_cnt": splan.slot_cnt[0], "wedges": splan.wedge_cnt}
    for name, wb in (("unblocked", 8_000_000), ("blocked", blocked)):
        if not wb:
            continue
        m = _module(lambda: SparseGTN(**kw, wedge_block=wb), state)
        out = m(splan, torch.from_numpy(x))
        (out ** 2).sum().backward()
        res[name] = {"out": _np(out), "grads": _grads(m)}
    return res


def case_bench_scaling(mesh, argv):
    """``tools/bench_scaling.py``'s JSON records on this world."""
    from graphneuralnetwork_tpu_torch.tools import bench_scaling

    return bench_scaling.main(argv)


def case_multihost(mesh):
    """The mesh helpers inside a world."""
    import torch.distributed as dist

    from graphneuralnetwork_tpu_torch.parallel import (
        initialize_distributed, is_primary, make_mesh, process_count)

    initialize_distributed(device="cpu")   # already initialised: a no-op
    res = {"process_count": process_count(), "is_primary": is_primary(),
           "rank": dist.get_rank(), "mesh_1d": make_mesh().devices.tolist(),
           "mesh_1d_axes": make_mesh().axis_names}
    n = process_count()
    if n >= 4:
        m2 = make_mesh(("data", "model"), shape=(n // 2, 2), device="cpu")
        res["mesh_2d"] = m2.devices.tolist()
        res["mesh_2d_shape"] = m2.shape
        res["coords"] = m2.coords
        res["axes"] = {a: (m2.axis(a).devices.tolist(), m2.axis(a).rank,
                           m2.axis(a).group is not None)
                       for a in ("data", "model")}
        # every line's group was created on every rank: a collective over
        # each axis sums that line's ranks
        import torch
        from graphneuralnetwork_tpu_torch.parallel.collectives import (
            all_reduce_sum)
        res["axis_sums"] = {a: float(all_reduce_sum(torch.tensor(
            float(dist.get_rank())), m2.axis(a))) for a in ("data", "model")}
    try:
        make_mesh(("data", "model"))
        res["needs_shape"] = False
    except ValueError:
        res["needs_shape"] = True
    return res


def main(job_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from graphneuralnetwork_tpu_torch.parallel import (
        initialize_distributed, make_mesh)

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    world = job["world"]
    dist.init_process_group("gloo", init_method=job["init"],
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT_S))
    initialize_distributed(device="cpu")
    mesh = make_mesh(device="cpu")
    results = {}
    try:
        for name, case, kwargs in job["cases"]:
            results[name] = globals()[f"case_{case}"](mesh, **kwargs)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        with open(f"{job_path}.{rank}", "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
