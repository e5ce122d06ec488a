"""One run of one cell: set-up, the checked first steps, the measured (or
traced) window, then the reference and the comparison.

Set-up builds one training object (the port's state and captured block)
and drives it through its first ``check.CHECK_STEPS`` epochs by the
block's own ``run()``, one epoch a call (the first call runs the eager
warm-up epoch and captures; each later one replays the captured epoch),
recording the dropout generator's state before each epoch, the gradient
the optimizer took (after the first, from AdamW's first moment; after
each replay, the captured ``.grad`` that it leaves) and the parameters
and AdamW's moments after each. The same object then trains the window
in the CLI's blocks of ``epochs_per_call``. Once the window has closed
and the peak memory is read, the program is freed and the reference does
the same steps from the same inputs: the first from the benchmark's own
initial weights, each later one from the state the program held before
it (``gnn.follow``).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from graphneuralnetwork_tpu_torch.ops.cuda.counters import read_launches

from . import check, generate, program, spec, trace
from .masks import MaskReplay
from .reference import gnn

_T0 = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def _adam_state(optimizer, names: dict) -> gnn.State:
    """The parameters and AdamW's moments, copied; a moment the optimizer
    does not hold reads zero."""
    def moment(p, key):
        return optimizer.state[p].get(key, torch.zeros_like(p)).detach()

    return gnn.State({k: p.detach().clone() for k, p in names.items()},
                     {k: moment(p, "exp_avg").clone()
                      for k, p in names.items()},
                     {k: moment(p, "exp_avg_sq").clone()
                      for k, p in names.items()})


def run_cell(s: dict, seed: int, seconds: float, traced: bool,
             device) -> tuple[dict, dict, list[dict]]:
    """``(result, checks, info)``: the result line's object, the compared
    numbers with their limits, and the lines printed before it."""
    cfg, cell = s["config"], s["cell"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spans, ages = {}, {"start": process_age_s()}
    t = time.perf_counter()
    ds = generate.make_dataset(s["mix"], seed, device)
    params0 = gnn.initial_params(cfg, generate.sub_seed(seed, 1),
                                  device)
    program.sync(device)
    spans["generate_s"] = time.perf_counter() - t
    ages["generated"] = process_age_s()
    prog = program.build(ds, cfg, cell["layout"], params0, seed, device)
    spans["graph_build_s"] = prog.graph_build_s
    ages["built"] = process_age_s()

    block, state = prog.block, prog.state
    gen = state.generator
    names = dict(prog.model.named_parameters())
    beta1 = cfg["optimizer"]["betas"][0]
    gen_states, rows, grads = [], [], []
    states = [gnn.start_state(params0)]
    block.epochs_per_call = 1
    for step in range(check.CHECK_STEPS):
        gen_states.append(gen.get_state())
        t = time.perf_counter()
        rows.append(block.run()[0])
        program.sync(device)
        if step == 0:
            spans["first_block_s"] = time.perf_counter() - t
            # the capture that ends the first call leaves no gradient
            # behind: the warm-up step's is AdamW's first moment, (1 - b1) g;
            # an optimizer that kept no moment was handed no gradient
            grads.append({k: state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)).double() / (1 - beta1)
                for k, p in names.items()})
        else:
            # a replay leaves its gradient in the captured ``.grad``
            grads.append({k: (torch.zeros_like(p) if p.grad is None
                              else p.grad).double()
                          for k, p in names.items()})
        states.append(_adam_state(state.optimizer, names))
    block.epochs_per_call = cfg["epochs_per_call"]
    program.sync(device)
    setup_s = ages["checked"] = process_age_s()

    failed = 0

    def run_block():
        nonlocal failed
        r = block.run()
        failed += int((~np.isfinite(r)).any(axis=1).sum())

    before = read_launches()
    window, tr = None, None
    if traced:
        tr = trace.traced_blocks(run_block, block.epochs_per_call, seconds)
        epochs = tr["epochs"]
    else:
        t0 = time.perf_counter()
        epochs = 0
        while True:
            run_block()
            epochs += block.epochs_per_call
            if time.perf_counter() - t0 >= seconds:
                break
        window = {"epochs": epochs, "seconds": time.perf_counter() - t0}
    launches = {k: (n - before[k]) / epochs
                for k, n in read_launches().items() if n != before[k]}
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # the program's part ends here: masks from its random stream, then free
    edges = gnn.canonical_edges(ds.senders, ds.receivers, ds.n_nodes, device)
    replay = MaskReplay(cfg, prog.data.graph, prog.perm, edges.keys, device)
    masks = [replay.step(st, gen.device) for st in gen_states]
    tiled = program.tiled_fraction(prog.data.graph)
    program_side = gnn.Readings(
        losses=[float(r[0]) for r in rows],
        val_losses=[float(r[2]) for r in rows], grads=grads,
        steps=[{k: b.params[k] - a.params[k] for k in a.params}
               for a, b in zip(states, states[1:])], states=states)
    del prog, block, state, gen, names
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    ref = gnn.follow(cfg, states, ds.features, dev(ds.labels),
                     dev(ds.train_idx), dev(ds.val_idx), edges, masks)
    numbers = check.numbers(program_side, ref)
    gaps = check.detail(program_side, ref)
    numbers.update(keep_z=replay.z, edge_cover=float(replay.uncovered),
                   nonfinite_epochs=float(failed))
    correct, checks = check.judge(numbers, cell["limits"])
    reference_s = time.perf_counter() - t

    ctx = {"cfg": cfg, "cell": cell, "n": ds.n_nodes,
           "e": int(edges.recv.shape[0]), "spans": spans, "window": window,
           "setup_s": setup_s, "memory_peak_bytes": peak}
    if tr is not None:
        ctx["trace"] = tr
    metrics = {}
    for m in (s["per_layer"] if traced else s["end_to_end"]):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name() if cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result = {"correct": correct, "attempted": epochs, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        result["breakdown"] = tr["breakdown"]
    result["checks"] = checks
    info = [{"cell": s["name"], "seed": seed, "tiled_fraction": tiled,
             "nodes": ds.n_nodes, "edges": ctx["e"],
             "launches_per_epoch": launches},
            {"setup_parts_s": spans, "setup_s": setup_s,
             "process_age_s": ages,
             "reference_s": reference_s, "window": window},
            {"gaps": gaps}]
    return result, checks, info
