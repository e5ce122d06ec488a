"""Seconds of the captured block's first ``run()``: the graph caches, the
eager warm-up epoch and the capture (``train/scan_loop.py``). A host span
of the benchmark, ended by a synchronisation."""


def read(ctx):
    return ctx["spans"].get("first_block_s")
