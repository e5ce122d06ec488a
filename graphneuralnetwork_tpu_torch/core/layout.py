"""Automatic graph-layout selection: probe locality, pick hybrid or COO.

Copy of ``graphneuralnetwork_tpu/core/layout.py`` (host numpy), so that
``--layout auto`` makes the reference's decision on the same edges; the
loader then builds the chosen layout (``core/bcsr.py`` for hybrid).

The thresholds are the reference's. ``spmm`` decides on the modeled
hybrid/COO traffic ratio (hybrid iff <= 0.75); ``attention`` on the
fraction of edges that land in dense tiles (hybrid iff >= 0.25).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .reorder import locality_order, relabel_edges

#: Dense tile shape of the reference's hybrid layout.
ROW_BLOCK = 128
COL_BLOCK = 128
MAX_BYTE_RATIO = 0.75
MIN_ATTENTION_TILED_FRACTION = 0.25
#: A tile is dense (worth a 128x128 block) from this many edges on.
MIN_EDGES_PER_TILE = 192
#: Nominal feature width for the traffic model.
PROBE_FEAT = 128


def _tile_keys(senders, receivers, n_nodes: int) -> np.ndarray:
    n_cb = -(-max(n_nodes, 1) // COL_BLOCK)
    return ((np.asarray(receivers, np.int64) // ROW_BLOCK) * n_cb
            + np.asarray(senders, np.int64) // COL_BLOCK)


def bcsr_memory_bytes(senders, receivers, n_nodes: int) -> int:
    """Tile-store footprint of the hybrid layout, without building it."""
    t = len(np.unique(_tile_keys(senders, receivers, n_nodes)))
    return t * ROW_BLOCK * COL_BLOCK * 4


def tiled_edge_fraction(senders, receivers, n_nodes: int) -> float:
    """Fraction of edges in dense tiles."""
    if len(senders) == 0:
        return 0.0
    _, inv, cnt = np.unique(_tile_keys(senders, receivers, n_nodes),
                            return_inverse=True, return_counts=True)
    return float((cnt[inv] >= MIN_EDGES_PER_TILE).mean())


def probe_layout(senders: np.ndarray, receivers: np.ndarray,
                 n_nodes: int, *,
                 min_edges_per_tile: int = MIN_EDGES_PER_TILE
                 ) -> Tuple[float, float, np.ndarray]:
    """Cluster the nodes and model both layouts' traffic per SpMM, with
    tiles dense from ``min_edges_per_tile`` edges on.

    Returns ``(tiled_fraction, byte_ratio, perm)``: the edge mass in dense
    tiles, the modeled hybrid/COO bytes ratio (1.0 when nothing tiles) and
    the clustering permutation.
    """
    s = np.asarray(senders, np.int64).ravel()
    r = np.asarray(receivers, np.int64).ravel()
    perm = locality_order(s, r, n_nodes)
    s2, r2 = relabel_edges(perm, s, r)
    e = len(s2)
    if e == 0:
        return 0.0, 1.0, perm
    _, inv, cnt = np.unique(_tile_keys(s2, r2, n_nodes),
                            return_inverse=True, return_counts=True)
    dense = cnt >= min_edges_per_tile
    t_dense = int(dense.sum())
    e_rem = int(cnt[~dense].sum())
    bytes_coo = e * PROBE_FEAT * 4
    bytes_hyb = (t_dense * (ROW_BLOCK * COL_BLOCK + COL_BLOCK * PROBE_FEAT)
                 * 4 + e_rem * PROBE_FEAT * 4)
    frac = float(dense[inv].mean())
    return frac, bytes_hyb / bytes_coo, perm


def choose_layout(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_nodes: int,
    *,
    min_edges_per_tile: int = MIN_EDGES_PER_TILE,
    objective: str = "spmm",
    verbose: bool = False,
    tag: str = "graph",
) -> Tuple[str, float, np.ndarray]:
    """Decide ``"hybrid"`` vs ``"coo"``; returns ``(layout, byte_ratio,
    perm)`` and logs the decision when ``verbose``."""
    frac, ratio, perm = probe_layout(senders, receivers, n_nodes,
                                     min_edges_per_tile=min_edges_per_tile)
    if objective == "attention":
        layout = ("hybrid" if frac >= MIN_ATTENTION_TILED_FRACTION
                  else "coo")
        crit = (f"tiled fraction {frac:.3f} "
                f"{'>=' if layout == 'hybrid' else '<'} "
                f"{MIN_ATTENTION_TILED_FRACTION:g} (attention)")
    else:
        layout = "hybrid" if ratio <= MAX_BYTE_RATIO else "coo"
        crit = (f"modeled hybrid/COO traffic {ratio:.3f} "
                f"{'<=' if layout == 'hybrid' else '>'} "
                f"{MAX_BYTE_RATIO:g}")
    if verbose:
        print(f"layout auto [{tag}]: tiled-edge fraction {frac:.3f}, "
              f"{crit} -> {layout}")
    return layout, ratio, perm
