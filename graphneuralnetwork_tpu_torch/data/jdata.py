"""JData user-item dataset pipeline for MetaPath2Vec.

Port of the JAX package's ``data/jdata.py``, the reference's two-stage
ETL:

  1. ``process_jdata`` — the pandas feature and edge preparation of
     MetaPath2Vec/utils/data_procession.py:41-87: bucket the age strings,
     one-hot encode user demographics (age/sex/user_lv_cd) and item
     attributes (a1/a2/a3/cate/brand), keep only type-6 actions,
     de-duplicate, prefix ids with ``u_``/``i_``, and write
     user_features.csv / item_features.csv / node_features.csv /
     data_action.csv.
  2. ``load_jdata`` — read_JData (MetaPath2Vec/utils/
     generate_meta_paths_utils.py:8-19): sample ``sample_num`` action
     edges, build user/item vocab maps, and assemble the bipartite
     ``HeteroGraph`` with the U-I-U metapath schema, in the form
     ``models/embedding.py:run_metapath2vec`` consumes (hetero, metapath,
     type_offsets).

pandas is imported inside the functions that read or write CSVs, as in
JAX, so the rest of the port runs without it. Without a
``data_action.csv`` the loader takes a deterministic synthetic action
table with the same schema (``_synthetic_actions``), and reads no file.
The same files or seed give JAX's ``HeteroGraph``, metapath and type
offsets.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.hetero import HeteroGraph

# Age buckets of JData_User.csv (data_procession.py:5-21): the raw column
# holds labelled ranges; '-1' → 0, below-15 → 1, 16-25 → 2, 26-35 → 3,
# 36-45 → 4, 46-55 → 5, above-56 → 6, anything else → -1.
_AGE_BUCKETS = {
    "-1": 0,
    "15岁以下": 1,
    "16-25岁": 2,
    "26-35岁": 3,
    "36-45岁": 4,
    "46-55岁": 5,
    "56岁以上": 6,
}


def convert_age(age_str) -> int:
    return _AGE_BUCKETS.get(str(age_str), -1)


def process_jdata(data_dir: str, out_dir: Optional[str] = None,
                  action_file: str = "JData_Action_201602.csv"):
    """Raw JData CSVs → processed feature/edge CSVs (data_procession.py).

    Returns ``(node_features, action)`` DataFrames and writes
    user_features.csv, item_features.csv, node_features.csv,
    data_action.csv into ``out_dir`` (defaults to ``data_dir``).
    """
    import pandas as pd

    out_dir = out_dir or data_dir
    user = pd.read_csv(os.path.join(data_dir, "JData_User.csv"),
                       encoding="gbk")
    item = pd.read_csv(os.path.join(data_dir, "JData_Product.csv"),
                       encoding="gbk")
    action = pd.read_csv(os.path.join(data_dir, action_file),
                         encoding="gbk")

    user = user.copy()
    user["age"] = user["age"].map(convert_age)
    user["user_id"] = "u_" + user["user_id"].astype(int).astype(str)
    onehots = [pd.get_dummies(user[c], prefix=c)
               for c in ("age", "sex", "user_lv_cd")]
    data_user = pd.concat([user["user_id"], *onehots], axis=1)

    item = item.copy()
    item["sku_id"] = "i_" + item["sku_id"].astype(int).astype(str)
    onehots = [pd.get_dummies(item[c], prefix=c)
               for c in ("a1", "a2", "a3", "cate", "brand")]
    data_item = pd.concat([item["sku_id"], *onehots], axis=1)

    # Keep only "order" actions (type == 6), drop payload columns, dedup.
    action = action[action["type"] == 6].copy()
    action = action.drop(
        columns=[c for c in ("time", "model_id", "type", "cate", "brand")
                 if c in action.columns])
    action = action.drop_duplicates()
    action["user_id"] = "u_" + action["user_id"].astype(int).astype(str)
    action["sku_id"] = "i_" + action["sku_id"].astype(int).astype(str)

    data_user = data_user[data_user["user_id"].isin(action["user_id"])]
    data_user = data_user.rename(columns={"user_id": "node_id"})
    data_item = data_item[data_item["sku_id"].isin(action["sku_id"])]
    data_item = data_item.rename(columns={"sku_id": "node_id"})

    node_features = pd.concat([data_user, data_item], ignore_index=True)
    node_features = node_features.fillna(0)

    os.makedirs(out_dir, exist_ok=True)
    data_user.to_csv(os.path.join(out_dir, "user_features.csv"), index=False)
    data_item.to_csv(os.path.join(out_dir, "item_features.csv"), index=False)
    node_features.to_csv(os.path.join(out_dir, "node_features.csv"),
                         index=False)
    action.to_csv(os.path.join(out_dir, "data_action.csv"), index=False)
    return node_features, action


@dataclass
class JData:
    """read_JData output in run_metapath2vec form."""
    hetero: HeteroGraph
    metapath: List[tuple]
    type_offsets: Dict[str, int]
    idx_to_users: List[str]
    idx_to_items: List[str]
    user_features: Optional[object] = None
    item_features: Optional[object] = None
    extras: dict = field(default_factory=dict)


def _synthetic_actions(seed: int, n_users: int = 200, n_items: int = 150,
                       n_edges: int = 2000):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, n_edges)
    i = rng.integers(0, n_items, n_edges)
    users = [f"u_{x}" for x in u]
    items = [f"i_{x}" for x in i]
    return users, items


def load_jdata(root: Optional[str] = None, sample_num: int = 10000,
               seed: int = 0) -> JData:
    """Processed data_action.csv → bipartite HeteroGraph + U-I-U schema
    (read_JData, generate_meta_paths_utils.py:8-19). Falls back to a
    synthetic action table when no files exist."""
    users = items = None
    user_feats = item_feats = None
    if root is not None:
        path = os.path.join(root, "data_action.csv")
        if os.path.exists(path):
            import pandas as pd

            edge_f = pd.read_csv(path)
            if len(edge_f) > sample_num:
                edge_f = edge_f.sample(sample_num, random_state=seed)
            users = edge_f["user_id"].astype(str).tolist()
            items = edge_f["sku_id"].astype(str).tolist()
            for fname, attr in (("user_features.csv", "u"),
                                ("item_features.csv", "i")):
                fpath = os.path.join(root, fname)
                if os.path.exists(fpath):
                    df = pd.read_csv(fpath)
                    if attr == "u":
                        user_feats = df
                    else:
                        item_feats = df
    if users is None:
        users, items = _synthetic_actions(seed)

    # vocab maps (procession_graph): first-seen order
    user_to_idx: Dict[str, int] = {}
    item_to_idx: Dict[str, int] = {}
    for u in users:
        user_to_idx.setdefault(u, len(user_to_idx))
    for i in items:
        item_to_idx.setdefault(i, len(item_to_idx))
    idx_to_users = list(user_to_idx)
    idx_to_items = list(item_to_idx)

    src = np.array([user_to_idx[u] for u in users], np.int64)
    dst = np.array([item_to_idx[i] for i in items], np.int64)
    hetero = HeteroGraph({"user": len(idx_to_users),
                          "item": len(idx_to_items)})
    hetero.add_relation(("user", "ui", "item"), src, dst)
    hetero.add_relation(("item", "iu", "user"), dst, src)
    metapath = [("user", "ui", "item"), ("item", "iu", "user")]
    type_offsets = {"user": 0, "item": len(idx_to_users)}
    return JData(hetero=hetero, metapath=metapath,
                 type_offsets=type_offsets, idx_to_users=idx_to_users,
                 idx_to_items=idx_to_items, user_features=user_feats,
                 item_features=item_feats)
