"""The process-group helpers of the PyTorch port
(``parallel/multihost.py``), mirroring ``tests/test_multihost.py``: in one
process ``initialize_distributed`` is an idempotent no-op that leaves bare
cluster variables alone, a coordinator starts a process group (the call
recorded, not made), and ``make_mesh`` builds the one-process mesh and
asks for a shape beyond one axis; in a gloo world of 4 spawned processes
(``torch_world.py``) the 1-D mesh covers every rank, the 2-D mesh lays
them out host-major and only rank 0 is primary. Checkpoints are written by
the primary process only."""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402

from graphneuralnetwork_tpu_torch.parallel import (  # noqa: E402
    initialize_distributed, is_primary, make_mesh, multihost, process_count)

import torch_world  # noqa: E402

CLUSTER_VARIABLES = ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT",
                     "WORLD_SIZE", "RANK", "TPU_WORKER_HOSTNAMES")


@pytest.fixture
def recorded_init(monkeypatch):
    """``dist.init_process_group`` replaced by a recorder, the cluster
    variables cleared."""
    for k in CLUSTER_VARIABLES:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


def test_initialize_distributed_single_process_noop(recorded_init):
    initialize_distributed(device="cpu")   # no coordinator: a no-op
    initialize_distributed(device="cpu")   # idempotent
    assert recorded_init == []
    assert not dist.is_initialized()
    assert process_count() == 1
    assert is_primary()


@pytest.mark.parametrize("bare", [{"TPU_WORKER_HOSTNAMES": "a,b"},
                                  {"MASTER_ADDR": "10.0.0.1"}])
def test_initialize_distributed_ignores_bare_cluster_variables(
        recorded_init, monkeypatch, bare):
    for k, v in bare.items():
        monkeypatch.setenv(k, v)
    initialize_distributed(device="cpu")
    assert recorded_init == []


def test_initialize_distributed_passes_the_coordinator(recorded_init,
                                                       monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    initialize_distributed(num_processes=2, process_id=1, device="cpu")
    (kw,) = recorded_init
    assert kw["init_method"] == "tcp://10.0.0.1:1234"
    assert (kw["world_size"], kw["rank"], kw["backend"]) == (2, 1, "gloo")
    assert kw["timeout"].total_seconds() <= multihost.DEFAULT_TIMEOUT_S


def test_initialize_distributed_reads_torchrun(recorded_init, monkeypatch):
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"),
                 ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(k, v)
    initialize_distributed(device="cpu")
    (kw,) = recorded_init
    assert kw["init_method"] == "env://"
    assert (kw["world_size"], kw["rank"]) == (4, 3)


def test_initialize_distributed_needs_the_process_count(recorded_init,
                                                        monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="process count"):
        initialize_distributed(device="cpu")


def test_make_mesh_1d_covers_all_processes():
    mesh = make_mesh(("data",), device="cpu")
    assert mesh.size == process_count() == 1
    assert mesh.axis_names == ("data",)
    assert mesh.shape == {"data": 1}
    assert mesh.rank == 0 and mesh.group is None


def test_make_mesh_2d_requires_shape():
    with pytest.raises(ValueError):
        make_mesh(("data", "model"), device="cpu")


def test_make_mesh_rejects_a_shape_that_does_not_hold_the_processes():
    with pytest.raises(ValueError):
        make_mesh(("data", "model"), shape=(2, 2), device="cpu")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return torch_world.run_world(tmp_path_factory.mktemp("multihost"), 4,
                                 [("mh", "multihost", {})])


def test_mesh_in_a_world_of_four(world4):
    for rank, res in enumerate(world4):
        got = res["mh"]
        assert got["process_count"] == 4
        assert got["rank"] == rank
        assert got["is_primary"] == (rank == 0)
        assert got["mesh_1d"] == [0, 1, 2, 3]
        assert got["mesh_1d_axes"] == ("data",)
        assert got["needs_shape"]


def test_make_mesh_2d_host_major(world4):
    for res in world4:
        assert res["mh"]["mesh_2d"] == [[0, 1], [2, 3]]
        assert res["mh"]["mesh_2d_shape"] == {"data": 2, "model": 2}


def test_make_mesh_2d_axis_submeshes(world4):
    """Each rank's 1-D meshes along "data" and "model" of the 2×2 mesh:
    its coordinates, the lines through it, and a collective over each
    (every rank created every line's group)."""
    for rank, res in enumerate(world4):
        got = res["mh"]
        d, m = divmod(rank, 2)
        assert tuple(got["coords"]) == (d, m)
        assert got["axes"]["data"] == ([m, 2 + m], d, True)
        assert got["axes"]["model"] == ([2 * d, 2 * d + 1], m, True)
        assert got["axis_sums"] == {"data": float(m + 2 + m),
                                    "model": float(4 * d + 1)}


def test_one_rank_mesh_axes_are_the_identity():
    """A 1×1 mesh without a process group (the card's world of 1): its
    axis meshes hold this process, with no group."""
    mesh = make_mesh(("data", "model"), shape=(1, 1), device="cpu")
    assert mesh.coords == (0, 0)
    for a in ("data", "model"):
        sub = mesh.axis(a)
        assert sub.devices.tolist() == [0] and sub.rank == 0
        assert sub.group is None and sub.axis_names == (a,)
    flat = make_mesh(device="cpu")
    assert flat.axis("data") is flat
    assert flat.axis("model").size == 1 and flat.axis("model").rank == 0


def test_checkpoint_written_by_the_primary_only(tmp_path, monkeypatch):
    from graphneuralnetwork_tpu_torch.nn import GCN
    from graphneuralnetwork_tpu_torch.train.checkpoint import save_checkpoint
    from graphneuralnetwork_tpu_torch.train.loop import TrainState

    model = GCN(4, hidden=2, num_classes=2)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1),
                       None, torch.Generator())
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, 3)
    assert not os.path.exists(path)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    assert os.path.exists(save_checkpoint(str(tmp_path / "ckpt"), state, 3))
