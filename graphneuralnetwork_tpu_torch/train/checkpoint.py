"""Checkpoint save/restore: params, optimizer (and schedule) state, epoch.

Port of ``graphneuralnetwork_tpu/train/checkpoint.py``'s two backends:

  * ``file`` (default), the msgpack backend's port onto ``torch.save``:
    one file, written atomically, loaded with ``weights_only=True``
    (tensors and plain containers only). Only the primary process writes
    it (``parallel/multihost.py:is_primary``): every rank of a
    data-parallel run holds the same parameters, and concurrent writers
    would race.
  * ``dcp``, the sharding-aware orbax backend's port onto
    ``torch.distributed.checkpoint``: ``ckpt_dir/dcp/<step>/``, where every
    rank writes its own shards. A tensor-parallel model's slices
    (``parallel/tp_models.py``: its ``mesh`` and ``specs``) and their
    optimizer moments go in as ``DTensor``s placed by the rule's spec
    (``Shard`` along the dimension a mesh axis splits, ``Replicate``
    along the others); replicated tensors go in whole and are written
    once. Save and restore are collective: every rank calls them (the
    primary alone would hang the world). Only the latest step is kept, as
    JAX's manager keeps one.

``restore_checkpoint`` and ``latest_step`` read whichever backend wrote
last (``last_backend``: the primary records it beside the checkpoint
after every save).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from .loop import TrainState

FILENAME = "checkpoint.pt"
DCP_DIR = "dcp"
#: the backend and step of the last save, written by the primary
LAST = "latest.json"
BACKENDS = ("file", "dcp")


def _path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, FILENAME)


def _dcp_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), DCP_DIR, str(int(step)))


def _record(ckpt_dir: str, backend: str, step: int) -> None:
    """The primary's note of the last save (atomic)."""
    p = os.path.join(ckpt_dir, LAST)
    with open(p + ".tmp", "w") as f:
        json.dump({"backend": backend, "step": int(step)}, f)
    os.replace(p + ".tmp", p)


def _dcp_steps(ckpt_dir: str) -> list:
    d = os.path.join(ckpt_dir, DCP_DIR)
    if not os.path.isdir(d):
        return []
    return sorted(int(s) for s in os.listdir(d)
                  if s.isdigit() and os.path.exists(
                      os.path.join(d, s, ".metadata")))


def last_backend(ckpt_dir: str) -> Optional[str]:
    """The backend that wrote last in ``ckpt_dir`` (None: no checkpoint).
    Without the primary's note (a checkpoint of an earlier version), the
    newer of the file and the latest ``dcp`` step."""
    p = os.path.join(ckpt_dir, LAST)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)["backend"]
    stamps = {}
    if os.path.exists(_path(ckpt_dir)):
        stamps["file"] = os.stat(_path(ckpt_dir)).st_mtime_ns
    steps = _dcp_steps(ckpt_dir)
    if steps:
        stamps["dcp"] = os.stat(os.path.join(
            _dcp_path(ckpt_dir, steps[-1]), ".metadata")).st_mtime_ns
    return max(stamps, key=stamps.get) if stamps else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    backend: str = "file") -> str:
    """Save ``state`` at ``step``; returns the file or the step's
    directory. ``backend="dcp"`` is collective (module docstring)."""
    from ..parallel.multihost import is_primary

    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    if backend == "dcp":
        return _save_dcp(ckpt_dir, state, step)
    p = _path(ckpt_dir)
    if not is_primary():
        return p
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "params": state.model.state_dict(),
        "opt_state": state.optimizer.state_dict(),
        "scheduler": (None if state.scheduler is None
                      else state.scheduler.state_dict()),
    }
    tmp = p + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, p)  # atomic — a crash never leaves a torn checkpoint
    _record(ckpt_dir, "file", step)
    return p


def restore_checkpoint(ckpt_dir: str,
                       state: TrainState) -> tuple[TrainState, int]:
    """Load params and optimizer state into ``state`` from the backend
    that wrote last; returns (state, step). Raises FileNotFoundError when
    there is no checkpoint. A ``dcp`` restore is collective."""
    if last_backend(ckpt_dir) == "dcp":
        return _restore_dcp(ckpt_dir, state, _dcp_steps(ckpt_dir)[-1])
    p = _path(ckpt_dir)
    if not os.path.exists(p):
        raise FileNotFoundError(f"no checkpoint at {p}")
    device = next(state.model.parameters()).device
    payload = torch.load(p, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    if state.scheduler is not None and payload["scheduler"] is not None:
        state.scheduler.load_state_dict(payload["scheduler"])
    return state, int(payload["step"])


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step of the last checkpoint in ``ckpt_dir``; ``None`` when
    there is none."""
    backend = last_backend(ckpt_dir)
    if backend == "dcp":
        return _dcp_steps(ckpt_dir)[-1]
    p = _path(ckpt_dir)
    if backend is None or not os.path.exists(p):
        return None
    return int(torch.load(p, map_location="cpu", weights_only=True)["step"])


# ---------------------------------------------------------------------------
# the sharded backend
# ---------------------------------------------------------------------------


def _device_mesh(mesh):
    """The ``DeviceMesh`` over a port ``Mesh``'s ranks, built once per mesh
    (its creation is collective)."""
    dm = mesh.__dict__.get("_device_mesh")
    if dm is None:
        from torch.distributed.device_mesh import DeviceMesh
        dm = DeviceMesh(mesh.device.type,
                        torch.as_tensor(mesh.devices, dtype=torch.int64),
                        mesh_dim_names=tuple(mesh.axis_names))
        object.__setattr__(mesh, "_device_mesh", dm)
    return dm


def _sharded(model, name: str):
    """(mesh, spec) where ``name`` of ``model`` is split over more than
    one rank, else None."""
    mesh, specs = getattr(model, "mesh", None), getattr(model, "specs", None)
    if mesh is None or specs is None or not dist.is_initialized():
        return None
    spec = specs.get(name, ())
    if not any(a is not None and mesh.shape.get(a, 1) > 1 for a in spec):
        return None
    return mesh, spec


def _global_shape(t: torch.Tensor, where) -> tuple:
    """The whole tensor's shape of this rank's slice ``t``."""
    shape = list(t.shape)
    if where is not None:
        mesh, spec = where
        for dim, a in enumerate(spec):
            if a is not None:
                shape[dim] *= mesh.shape.get(a, 1)
    return tuple(shape)


def _global(t: torch.Tensor, where):
    """``t`` as the checkpoint holds it: a ``DTensor`` of this rank's slice
    where ``where`` = (mesh, spec), else ``t``."""
    if where is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, spec = where
    placements = [Shard(spec.index(a)) if a in spec else Replicate()
                  for a in mesh.axis_names]
    shape = _global_shape(t, where)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.detach().contiguous(), _device_mesh(mesh),
                              placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _restored(v, p: torch.Tensor):
    """An optimizer state entry of parameter ``p`` as loaded: this rank's
    slice of a moment on ``p``'s device; other entries as they are."""
    if not torch.is_tensor(v):
        return v
    v = _local(v)
    return v.to(p.device) if v.shape == p.shape else v


def _payload(state: TrainState, step: int) -> dict:
    """What the sharded backend saves: the step, the parameters and each
    parameter's optimizer state by its name, the schedule's state."""
    model = state.model
    names = {p: k for k, p in model.named_parameters()}
    opt = {}
    for p, st in state.optimizer.state.items():
        k = names[p]
        opt[k] = {key: (_global(v, _sharded(model, k))
                        if torch.is_tensor(v) and v.shape == p.shape else v)
                  for key, v in st.items()}
    return {
        "step": torch.tensor(int(step)),
        "params": {k: _global(v, _sharded(model, k))
                   for k, v in model.state_dict().items()},
        "opt_state": opt,
        "scheduler": (None if state.scheduler is None
                      else state.scheduler.state_dict()),
    }


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _save_dcp(ckpt_dir: str, state: TrainState, step: int) -> str:
    import torch.distributed.checkpoint as dcp

    from ..parallel.multihost import is_primary

    path = _dcp_path(ckpt_dir, step)
    dcp.save(_payload(state, step), checkpoint_id=path,
             no_dist=not dist.is_initialized())
    _barrier()
    if is_primary():
        for old in _dcp_steps(ckpt_dir):
            if old != int(step):
                shutil.rmtree(_dcp_path(ckpt_dir, old), ignore_errors=True)
        _record(ckpt_dir, "dcp", step)
    _barrier()
    return path


def _restore_dcp(ckpt_dir: str, state: TrainState,
                 step: int) -> tuple[TrainState, int]:
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = _dcp_path(ckpt_dir, step)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    model = state.model
    params = dict(model.named_parameters())
    opt = {}
    for key, md in meta.items():
        if not key.startswith("opt_state."):
            continue
        name, _, leaf = key[len("opt_state."):].rpartition(".")
        p = params[name]
        if isinstance(md, TensorStorageMetadata):
            where = _sharded(model, name)
            if tuple(md.size) == _global_shape(p, where):
                value = _global(torch.zeros_like(p), where)
            else:
                value = torch.zeros(md.size, dtype=md.properties.dtype)
        else:
            value = None
        opt.setdefault(name, {})[leaf] = value
    template = {
        "step": torch.tensor(0),
        "params": {k: _global(v.detach().clone(), _sharded(model, k))
                   for k, v in model.state_dict().items()},
        "opt_state": opt,
        "scheduler": (None if state.scheduler is None
                      else state.scheduler.state_dict()),
    }
    dcp.load(template, checkpoint_id=path,
             no_dist=not dist.is_initialized())
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(_local(template["params"][k]))
    for name, st in opt.items():
        p = params[name]
        state.optimizer.state[p] = {key: _restored(v, p)
                                    for key, v in st.items()}
    if state.scheduler is not None and template["scheduler"] is not None:
        state.scheduler.load_state_dict(template["scheduler"])
    return state, int(template["step"])
