"""Seconds from the generated arrays to the port's warmed device graph:
the builders (``core/graph.py``, ``core/bcsr.py``), the locality order
(``core/reorder.py``) on the hybrid layout, and ``warm()``. A host span
of the benchmark around the port's calls."""


def read(ctx):
    return ctx["spans"].get("graph_build_s")
