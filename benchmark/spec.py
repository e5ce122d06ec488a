"""Finds a cell's files by name: ``BENCHMARK.json`` at the checkout's root,
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json``, ``metrics/<metric>.py``, and for the configuration's
``model`` its program side ``models/<model>.py`` and its plain reference
``reference/<model>.py``."""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str) -> dict:
    """The cell's entry and files, and the metrics it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r} "
                         f"(known: {', '.join(entries)})")
    entry = entries[workload]
    cell = load_json(HERE / "workloads" / f"{workload}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise SystemExit(f"{workload}: BENCHMARK.json and the workload file "
                         "name different configurations or mixes")
    cfg = load_json(HERE / "configs" / f"{entry['config']}.json")
    for folder in ("models", "reference"):
        if not (HERE / folder / f"{cfg['model']}.py").is_file():
            raise SystemExit(f"{workload}: no {folder}/{cfg['model']}.py for "
                             f"the configuration's model")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    if (cfg["in_features"], cfg["num_classes"]) != (mix["features"],
                                                    mix["classes"]):
        raise SystemExit(f"{workload}: the configuration's input width or "
                         "classes differ from the mix's")

    def reported(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"name": workload, "entry": entry, "cell": cell, "config": cfg,
            "mix": mix, "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"])}


@functools.lru_cache(maxsize=None)
def part(folder: str, name: str):
    """The module ``<folder>/<name>.py``; an unknown name raises."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder}/{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    return part("metrics", metric).read
