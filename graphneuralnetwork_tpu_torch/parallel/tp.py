"""Tensor-parallel (dp × tp) parameter shardings on a 2-D mesh.

Port of ``graphneuralnetwork_tpu/parallel/tp.py``. JAX annotates the
weights with ``NamedSharding``s and GSPMD inserts every collective; the
port has no GSPMD, so this module holds the rules and each rank's slices,
and ``tp_models.py`` writes the collectives out in the Megatron pattern:

  * a mesh of "data" × "model" ranks (``make_tp_mesh``); node rows ride
    "data" (the halo partition on the data sub-mesh, ``mesh.axis``), the
    hidden and head dimensions ride "model";
  * a layer that produces the hidden dimension is column-sharded (its
    ``Linear.weight`` [out, in] split on dim 0, ``("model", None)``), the
    layer that consumes it row-sharded (dim 1, ``(None, "model")``), and
    its partial products summed by ``collectives.reduce_from``;
  * every parameter matches a rule, first match wins, and an unmatched one
    raises (``param_shardings``): a silently replicated weight defeats TP
    without an error.

The rules are JAX's rewritten for the port's names: scopes join with
``.`` and a flax Dense ``kernel`` [in, out] is a ``Linear.weight`` [out,
in] (``params.py``), so JAX's ``conv1/.*kernel (None, "model")`` is
``conv1\\..*weight ("model", None)``; the attention vectors [heads,
hidden] keep their layout. A slice that does not divide evenly raises
(``local_shard``), as JAX's ``device_put`` of such a sharding does.

**The gradient convention on the 2-D mesh.** After ``backward``, every
parameter's gradient, sharded or replicated, is summed over the **data**
sub-mesh only (``collectives.all_reduce_gradients(params,
mesh.axis("data"))``). The model ranks already agree on the replicated
parameters: ``reduce_from``'s backward is the identity, and a replicated
tensor that enters a column-sharded region passes ``copy_to``, whose
backward sums the partial gradients. A further model-axis all-reduce, or
a loss scaled by the model size, would double or halve gradients.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

from .multihost import Mesh


def make_tp_mesh(n_data: int, n_model: int, devices=None,
                 device: Optional[str | torch.device] = None) -> Mesh:
    """2-D mesh: leading axis "data" (node parallel), trailing axis
    "model" (feature parallel, kept within one host); every process calls
    it (it creates the axes' process groups)."""
    from .multihost import make_mesh
    return make_mesh(("data", "model"), shape=(n_data, n_model),
                     devices=devices, device=device)


class ShardRule:
    """One sharding rule: regex over the parameter's ``state_dict`` name
    (``a.b.c``) -> spec, a tuple of mesh axis names or None, one per
    leading dimension of the tensor. Rules are tried in order and the
    first match wins."""

    def __init__(self, pattern: str, spec: Sequence[Optional[str]]):
        self.pattern = pattern
        self._re = re.compile(pattern)
        self.spec = tuple(spec)

    def matches(self, name: str) -> bool:
        return self._re.search(name) is not None


def param_shardings(mesh: Mesh, params, rules: Sequence[ShardRule]) -> dict:
    """``{name: spec}`` for every tensor of ``params`` (a ``state_dict`` or
    a module). An unmatched parameter raises instead of silently
    replicating (add an explicit ``ShardRule(".*", ())`` tail when
    replicate-the-rest is intended); a spec of more axes than the tensor
    has dimensions raises too. An axis that ``mesh`` does not have counts
    as one rank (a 1-D "data" mesh holds every parameter whole)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    out = {}
    for name, leaf in params.items():
        for rule in rules:
            if rule.matches(name):
                if len(rule.spec) > leaf.ndim:
                    raise ValueError(
                        f"rule {rule.pattern!r} spec {rule.spec} has more "
                        f"axes than param {name} of shape "
                        f"{tuple(leaf.shape)}")
                out[name] = rule.spec
                break
        else:
            raise ValueError(
                f"no sharding rule matches param {name!r} (shape "
                f"{tuple(leaf.shape)}); add an explicit rule - params must "
                "not silently replicate under tensor parallelism")
    return out


# Model rule sets, in the port's names and layouts: the hidden or head
# dimension rides the "model" axis end to end; column-shard the layer that
# produces it (weight dim 0), row-shard the layer that consumes it (weight
# dim 1, the partial products summed by reduce_from), replicate scalars and
# small leaves explicitly.

def gcn_rules() -> list:
    return [
        ShardRule(r"conv1\..*weight", ("model", None)),
        ShardRule(r"conv1\.bias", ("model",)),
        ShardRule(r"conv2\..*weight", (None, "model")),
        ShardRule(r"conv2\.bias", ()),
    ]


def gat_rules() -> list:
    """GAT: the projection's output is heads·hidden (head-major), so
    column-sharding it splits whole heads over "model"; the attention
    vectors [heads, hidden] shard their head axis to match; the output
    layer consumes the concatenation row-sharded."""
    return [
        ShardRule(r"attn1\.linear\.weight", ("model", None)),
        ShardRule(r"attn1\.attn_(src|dst)", ("model", None)),
        ShardRule(r"attn_out\.linear\.weight", (None, "model")),
        ShardRule(r"attn_out\.attn_(src|dst)", ()),
        ShardRule(r"attn_out\.bias|attn1\.bias", ()),
    ]


def han_rules() -> list:
    """HAN: each metapath GAT column-shards heads·hidden; the semantic
    attention's projection and the classifier consume it row-sharded."""
    return [
        ShardRule(r"gat_mp\d+\.linear\.weight", ("model", None)),
        ShardRule(r"gat_mp\d+\.attn_(src|dst)", ("model", None)),
        ShardRule(r"semantic\.proj\.weight", (None, "model")),
        ShardRule(r"semantic\.proj\.bias", ()),
        ShardRule(r"semantic\.q", ()),
        ShardRule(r"classify\.weight", (None, "model")),
        ShardRule(r"classify\.bias", ()),
    ]


def gtn_rules() -> list:
    """GTN: the shared ``gcn_w`` column-shards its hidden dimension;
    ``linear1`` consumes channels·hidden (channel-major) row-sharded, its
    rows in contiguous blocks (``tp_models`` reshards the channels'
    hidden slices into them); the GTConv mixing weights are small and
    replicated."""
    return [
        ShardRule(r"gcn_w\.weight", ("model", None)),
        ShardRule(r"gt\d+\.conv\d+\.weight", ()),
        ShardRule(r"linear1\.weight", (None, "model")),
        ShardRule(r"linear1\.bias", ()),
        ShardRule(r"linear2\.weight", ()),
        ShardRule(r"linear2\.bias", ()),
    ]


MODEL_RULES = {
    "gcn": gcn_rules,
    "gat": gat_rules,
    "han": han_rules,
    "gtn": gtn_rules,
}


def model_param_shardings(mesh: Mesh, params, model: str) -> dict:
    """Specs for a named model family (gcn/gat/han/gtn)."""
    return param_shardings(mesh, params, MODEL_RULES[model]())


def gcn_param_shardings(mesh: Mesh, params) -> dict:
    """``model_param_shardings(mesh, params, "gcn")``."""
    return param_shardings(mesh, params, gcn_rules())


def local_shard(t: torch.Tensor, spec: Sequence[Optional[str]],
                shape: dict, coords: dict) -> torch.Tensor:
    """The block of ``t`` that the rank at ``coords`` ({axis: index}) of a
    mesh of ``shape`` ({axis: size}) holds under ``spec``: each dimension
    named by an axis split in that many equal blocks (an axis missing from
    ``shape`` has one rank). A dimension that does not divide raises."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is None or shape.get(axis, 1) == 1:
            continue
        k = shape[axis]
        if out.shape[dim] % k:
            raise ValueError(
                f"dimension {dim} of size {out.shape[dim]} does not split "
                f"evenly over the {k} ranks of mesh axis {axis!r}")
        size = out.shape[dim] // k
        out = out.narrow(dim, coords[axis] * size, size)
    return out


def apply_tp(params, shardings: dict, mesh: Mesh) -> dict:
    """This rank's slices of ``params`` (a ``state_dict`` or a module)
    under ``shardings`` (``param_shardings``), contiguous copies."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    coords = {a: mesh.coord(a) for a in mesh.axis_names}
    return {k: local_shard(v, shardings[k], mesh.shape,
                           coords).contiguous().clone()
            for k, v in params.items()}


def shard_rows(x, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``x`` [N, ...] over the mesh's ``axis``, on its
    device: the array zero-padded so that the axis divides it, then block
    ``coord(axis)``."""
    k = mesh.shape.get(axis, 1)
    x = np.asarray(x)
    pad = (-x.shape[0]) % k
    if pad:
        x = np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    rows = x.shape[0] // k
    lo = mesh.coord(axis) * rows
    return torch.from_numpy(np.ascontiguousarray(x[lo:lo + rows])).to(
        mesh.device)
