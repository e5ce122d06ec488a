"""Training CLI of the PyTorch port: ``python -m graphneuralnetwork_tpu_torch
--model gcn``.

The gcn/gat branch and the full-batch GraphSAGE branch of
``graphneuralnetwork_tpu/cli.py`` with the same defaults (GCN: hidden 128,
dropout 0.5, lr 2e-3, wd 5e-4, 4000 epochs; GAT: 8 heads x 8 hidden,
dropout 0.6, lr 1e-2, momentum 0.9, 1000 epochs; GraphSAGE: hidden 128,
lr 1e-2, wd 1e-4, 100 epochs in blocks of 50), plus ``--device`` (default
``cuda``; a run without a card raises unless ``--device cpu`` is given).
GCN on the hybrid layout trains on kernel K3 (tiles) and K1 (remainder).
GAT on the hybrid layout (``--layout hybrid``, and ``auto`` on Cora)
rebuilds the tiles from the relabelled raw edges with unit weights, as the
reference does, and trains on kernels K4-K6. ``--model graphsage --layout
hybrid`` trains full-batch GraphSAGE on the clustered Pubmed graph:
``--set aggregator=mean|sum`` on K3 and K1, ``--set aggregator=max`` on K7
and K2. The sampled GraphSAGE pipeline (``--model graphsage`` under
``auto``/``coo``, and ``graphsage_unsup``) is not ported yet and raises
NotImplementedError. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

#: The ``--set`` keys each model's branch reads.
_SET_KEYS = {"graphsage": ("aggregator", "lr")}
_SAMPLED_NOT_PORTED = (
    "the sampled GraphSAGE pipeline (sampling/, nn/sage.py, "
    "train/sage_loop.py) is not ported yet (ROADMAP.md queue 1 item 10b); "
    "use --model graphsage --layout hybrid for full-batch GraphSAGE")


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
                    help="graphsage: aggregator=mean|sum|max, lr=<float>")
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
                         "coo); graphsage runs on 'hybrid' only so far")
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
    unknown = sorted(set(overrides) - set(_SET_KEYS.get(name, ())))
    if unknown:
        ap.error(f"--set {', '.join(unknown)}: not a key of --model {name} "
                 f"(keys: {', '.join(_SET_KEYS.get(name, ())) or 'none'})")
    if name == "graphsage_unsup" or (name == "graphsage"
                                     and args.layout != "hybrid"):
        raise NotImplementedError(f"--model {name} --layout {args.layout}: "
                                  + _SAMPLED_NOT_PORTED)

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
