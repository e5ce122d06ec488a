"""Training CLI of the PyTorch port: ``python -m graphneuralnetwork_tpu_torch
--model gcn``.

The gcn/gat branch and the GraphSAGE branches of
``graphneuralnetwork_tpu/cli.py`` with the same defaults (GCN: hidden 128,
dropout 0.5, lr 2e-3, wd 5e-4, 4000 epochs; GAT: 8 heads x 8 hidden,
dropout 0.6, lr 1e-2, momentum 0.9, 1000 epochs; full-batch GraphSAGE:
hidden 128, lr 1e-2, wd 1e-4, 100 epochs in blocks of 50; sampled
GraphSAGE: ``SageConfig``, 5 epochs), plus ``--device`` (default ``cuda``;
a run without a card raises unless ``--device cpu`` is given).
GCN on the hybrid layout trains on kernel K3 (tiles) and K1 (remainder).
GAT on the hybrid layout (``--layout hybrid``, and ``auto`` on Cora)
rebuilds the tiles from the relabelled raw edges with unit weights, as the
reference does, and trains on kernels K4-K6. ``--model graphsage --layout
hybrid`` trains full-batch GraphSAGE on the clustered Pubmed graph:
``--set aggregator=mean|sum`` on K3 and K1, ``--set aggregator=max`` on K7
and K2. ``--model graphsage`` under ``auto``/``coo`` trains the sampled
mini-batch pipeline on the Pubmed data (``train/sage_loop.py``, no
kernel: fanout sampling on the host, or on the device with ``--set
device_sampling=true``), and ``--model graphsage_unsup`` (any layout) its
unsupervised mode; ``--set`` takes any ``SageConfig`` field there, and
``--optimizer sgd`` sets lr 0.1 and weight decay 1e-4 first. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json

#: The ``--set`` keys each branch reads: full-batch GraphSAGE (``--model
#: graphsage --layout hybrid``) two, the sampled branches every
#: ``SageConfig`` field (``train/sage_loop.py``).
_SAGE_FIELDS = ("fanouts", "hidden", "batch_size", "lr", "weight_decay",
                "epochs", "aggregator", "optimizer", "seed", "num_negatives",
                "walk_length", "device_sampling", "max_table_degree")
_SET_KEYS = {"graphsage_hybrid": ("aggregator", "lr"),
             "graphsage": _SAGE_FIELDS, "graphsage_unsup": _SAGE_FIELDS}


def _apply_overrides(cfg, overrides):
    """Set each ``KEY=VALUE`` of ``overrides`` (keys checked against
    ``_SET_KEYS`` by ``main``) on the dataclass ``cfg``, converted to the
    type of the field's current value (a tuple of ints from ``10,10``)."""
    for kv in overrides or []:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        elif isinstance(cur, tuple):
            v = tuple(int(x) for x in v.split(","))
        setattr(cfg, k, v)
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="PyTorch/CUDA GNN trainer (GCN, GAT, GraphSAGE)")
    ap.add_argument("--model", required=True,
                    choices=["gcn", "gat", "graphsage", "graphsage_unsup"])
    ap.add_argument("--dataset", default=None,
                    help="dataset path or 'cora'/'citeseer' (falls back to "
                         "the synthetic graph of that shape)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="graphsage --layout hybrid: aggregator=mean|sum|"
                         "max, lr=<float>; sampled graphsage and "
                         "graphsage_unsup: any SageConfig field, e.g. "
                         "fanouts=10,10, aggregator=max, "
                         "device_sampling=true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="load a prior checkpoint before training")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--optimizer", choices=["adamw", "sgd"], default=None,
                    help="adamw (default) or the reference's SGD + "
                         "warmup-poly recipe")
    ap.add_argument("--layout", choices=["auto", "coo", "hybrid"],
                    default="auto",
                    help="'auto' probes the clustered tile fill as the JAX "
                         "package does (GAT on Cora -> hybrid, GCN -> "
                         "coo); graphsage: 'hybrid' trains full-batch, "
                         "'auto'/'coo' the sampled pipeline")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="compute dtype (params stay float32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    name = args.model
    if any("=" not in kv for kv in args.set or []):
        ap.error("--set takes KEY=VALUE")
    overrides = dict(kv.split("=", 1) for kv in (args.set or []))
    branch = ("graphsage_hybrid" if name == "graphsage"
              and args.layout == "hybrid" else name)
    keys = _SET_KEYS.get(branch, ())
    unknown = sorted(set(overrides) - set(keys))
    if unknown:
        ap.error(f"--set {', '.join(unknown)}: not a key of --model {name} "
                 f"--layout {args.layout} (keys: {', '.join(keys) or 'none'})")
    if branch in ("graphsage", "graphsage_unsup"):
        return _sampled_sage(name, args)

    import torch

    from .core.device import resolve_device
    from .data import load_cora, load_pubmed_fullbatch
    from .nn import GAT, GCN, GraphSAGE
    from .train.schedule import make_optimizer

    device = resolve_device(args.device)
    verbose = not args.quiet
    cdtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    opt_name = args.optimizer or "adamw"
    if name == "graphsage":
        data = load_pubmed_fullbatch(root=args.dataset, seed=args.seed,
                                     layout="hybrid", device=device)
        model = GraphSAGE(int(data.features.shape[1]), hidden_dims=(128,),
                          num_classes=data.num_classes,
                          aggregator=overrides.get("aggregator", "mean"),
                          dtype=cdtype)
        epochs = args.epochs or 100
        opt = make_optimizer(opt_name, float(overrides.get("lr", 1e-2)),
                             weight_decay=1e-4, total_steps=epochs,
                             warmup_steps=1, momentum=0.9)
        return _fit(name, model, data, epochs, opt, min(50, epochs), args,
                    verbose, device)
    objective = "attention" if name == "gat" else "spmm"
    # GAT's hybrid attends over the unit-weight adjacency, not GCN's
    # normalised one (the loader builds it from the relabelled raw edges)
    # 'cora'/'citeseer' name a synthetic preset, anything else a path
    source = (dict(name=args.dataset) if args.dataset in ("cora", "citeseer")
              else dict(root=args.dataset))
    data = load_cora(**source, seed=args.seed, layout=args.layout,
                     layout_objective=objective, device=device, model=name,
                     tile_dtype=cdtype or torch.float32)
    in_features = int(data.features.shape[1])
    if name == "gcn":
        model = GCN(in_features, hidden=128, num_classes=data.num_classes,
                    dropout=0.5, dtype=cdtype)
        epochs = args.epochs or 4000
        opt = make_optimizer(opt_name, 2e-3, weight_decay=5e-4,
                             total_steps=epochs, warmup_steps=1,
                             momentum=0.9)
    else:
        model = GAT(in_features, hidden=8, num_heads=8,
                    num_classes=data.num_classes, dropout=0.6, dtype=cdtype)
        epochs = args.epochs or 1000
        opt = make_optimizer(opt_name, 1e-2, weight_decay=5e-4,
                             total_steps=epochs, warmup_steps=1,
                             momentum=0.9)
    return _fit(name, model, data, epochs, opt, min(100, epochs), args,
                verbose, device)


def _sampled_sage(name, args) -> dict:
    """The sampled GraphSAGE pipeline on the Pubmed data: ``graphsage``
    supervised (``test_acc``, ``history_tail``), ``graphsage_unsup`` its
    context/negative mode (``final_loss``, ``initial_loss``,
    ``binary_acc``)."""
    import time

    from .core.device import resolve_device
    from .data.pubmed import load_pubmed
    from .train.sage_loop import (SageConfig, train_sage_supervised,
                                  train_sage_unsupervised)

    device = resolve_device(args.device)
    data = load_pubmed(root=args.dataset, seed=args.seed)
    cfg = SageConfig(epochs=args.epochs or 5, seed=args.seed)
    if args.optimizer:
        cfg.optimizer = args.optimizer
        if args.optimizer == "sgd":
            # the reference recipe: SGD lr 0.1, wd 1e-4 under warmup-poly
            cfg.lr, cfg.weight_decay = 0.1, 1e-4
    cfg = _apply_overrides(cfg, args.set)
    verbose = not args.quiet
    t0 = time.perf_counter()
    if name == "graphsage":
        _, history, test_acc = train_sage_supervised(
            data, cfg, verbose=verbose, device=device)
        result = dict(test_acc=test_acc, history_tail=history[-1])
    else:
        _, history = train_sage_unsupervised(data, cfg, verbose=verbose,
                                             device=device)
        result = dict(final_loss=history[-1][1], initial_loss=history[0][1],
                      binary_acc=history[-1][2])
    seconds = time.perf_counter() - t0
    result.update(epochs=cfg.epochs, seconds=seconds,
                  # includes the process's first work on the device
                  epochs_per_s=cfg.epochs / seconds, device=str(device))
    print(json.dumps({"model": name, **result}))
    return result


def _fit(name, model, data, epochs, opt, epochs_per_call, args, verbose,
         device) -> dict:
    from .train.scan_loop import fit_node_classifier_scan

    res = fit_node_classifier_scan(
        model, data, epochs=epochs, optimizer=opt,
        epochs_per_call=epochs_per_call, seed=args.seed, verbose=verbose,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume)
    result = dict(test_acc=res.test_acc, val_acc=res.best_val_acc,
                  loss=res.history[-1][1], epochs=res.epochs_run,
                  seconds=res.seconds,
                  # includes the first block (kernel load, warm-up)
                  epochs_per_s=res.epochs_run / res.seconds,
                  device=str(device))
    print(json.dumps({"model": name, **result}))
    return result


if __name__ == "__main__":
    main()
