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
``--optimizer sgd`` sets lr 0.1 and weight decay 1e-4 first. ``--model
han`` trains HAN (hidden 8 x 4 heads, AdamW lr 5e-3 or SGD lr 0.05 under
warmup-poly, 100 epochs in chunks of 20, no dropout, as the reference) on
the synthetic ACM's PAP and PLP metapath graphs (``--dataset imdb``: the
synthetic IMDB; a path: an ACM.mat; ``--set n_papers=N``): ``auto`` picks
the hybrid layout there (kernels K4-K6), ``coo`` trains on K1 and K2.
``--model han_batch`` trains ``DenseHAN`` on node minibatches of dense
sub-adjacencies (plain PyTorch, no kernel; ``--set batch_size``, ``lr``,
``patience``). ``--model gtn`` trains GTN (2 channels, 2 layers, hidden 64,
AdamW at 2.5e-3 for the ``gt*`` layers and 5e-3 for the rest, weight decay
1e-3, 40 epochs in chunks of 10, as the reference) on the synthetic ACM's
edge-type stack (``--dataset imdb``: the synthetic IMDB; a path: a
``train.pkl`` or an ACM.mat): ``auto``/``coo`` the dense model (matrix
products, no kernel), ``--layout sparse`` the wedge-plan ``SparseGTN``
(K1). ``--model deepwalk|node2vec|struc2vec|line|sdne|metapath2vec``
trains the walk embedders (``models/embedding.py``, plain PyTorch, no
kernel; the skip-gram or SDNE epoch captured as a CUDA graph on the card)
at the reference's defaults on the 500-node synthetic small-world graph
(``--dataset``: an edge-list file; metapath2vec: the synthetic user-item
graph, or with ``--dataset DIR`` the JData pipeline on DIR's processed
``data_action.csv``, read with pandas, or the JData loader's synthetic
action table where DIR holds none), ``--set`` over any field of the
model's config
(``device_walks=true`` draws DeepWalk's, Node2vec's and MetaPath2Vec's
walks on the device). ``--model gatne`` trains GATNE
(``models/gatne.py``; dim 64, Adam lr 1e-2, 5 epochs; the epoch captured
as a CUDA graph on the card) on the 400-node synthetic multiplex
(``--dataset``: a directory holding ``train.txt``, ``valid.txt`` and
``test.txt``), ``--model bine`` BiNE (``models/bine.py``; dim 128, AdamW
lr 1e-2, 5 epochs, one eager step a batch) on the synthetic ratings, each
with ``--set`` over any field of its config (``loss=masked_bce``,
``inductive=true``, ``aggregator=sum``; ``logdir=DIR``), and ``--model
basis`` the centrality toolkit's demo on the Basis 10-node graph
(``analysis/demo.py``). None of the three launches a kernel of the port.
Prints one JSON line.
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
_WALK_FIELDS = ("num_walks", "walk_length", "window", "num_negatives",
                "embed_dim", "lr", "batch_size", "epochs", "seed", "p", "q",
                "subsample_t", "device_walks")
_SET_KEYS = {"graphsage_hybrid": ("aggregator", "lr"),
             "graphsage": _SAGE_FIELDS, "graphsage_unsup": _SAGE_FIELDS,
             "han": ("n_papers",),
             "han_batch": ("batch_size", "lr", "patience"),
             "deepwalk": _WALK_FIELDS, "node2vec": _WALK_FIELDS,
             "metapath2vec": _WALK_FIELDS,
             # struc2vec draws its walks on the host only
             "struc2vec": tuple(f for f in _WALK_FIELDS
                                if f != "device_walks"),
             "line": ("embed_dim", "num_negatives", "batch_size", "lr",
                      "epochs", "seed"),
             "sdne": ("hidden_dims", "alpha", "beta", "weight_decay",
                      "batch_size", "lr", "epochs", "seed"),
             "gatne": ("embed_dim", "edge_embed_dim", "attn_dim",
                       "num_walks", "walk_length", "window",
                       "num_negatives", "neighbor_samples", "batch_size",
                       "lr", "epochs", "seed", "inductive",
                       "negative_sampling", "aggregator", "loss",
                       "cache_dir"),
             "bine": ("embed_dim", "alpha", "beta", "gamma", "max_t",
                      "min_t", "p_stop", "percent", "window",
                      "num_negatives", "batch_size", "lr", "epochs", "seed",
                      "logdir")}
_EMBEDDERS = ("deepwalk", "node2vec", "struc2vec", "line", "sdne",
              "metapath2vec")
_LINKPRED = ("gatne", "bine")
#: The models each layout but ``auto``/``coo`` serves.
_LAYOUT_MODELS = {"hybrid": ("gcn", "gat", "graphsage", "han",
                             "graphsage_unsup"),
                  "sparse": ("gtn",)}


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
        description="PyTorch/CUDA GNN trainer (GCN, GAT, GraphSAGE, HAN, "
                    "GTN, the walk embedders, GATNE, BiNE, the centrality "
                    "demo)")
    ap.add_argument("--model", required=True,
                    choices=["gcn", "gat", "graphsage", "graphsage_unsup",
                             "han", "han_batch", "gtn", *_EMBEDDERS,
                             *_LINKPRED, "basis"])
    ap.add_argument("--dataset", default=None,
                    help="dataset path or 'cora'/'citeseer' (falls back to "
                         "the synthetic graph of that shape); han and "
                         "han_batch: an ACM.mat path or 'imdb'; gtn: a "
                         "train.pkl or ACM.mat path or 'imdb'; the walk "
                         "embedders but metapath2vec: an edge-list file; "
                         "gatne: a directory of train.txt, valid.txt and "
                         "test.txt; metapath2vec: a directory of processed "
                         "JData CSVs")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="graphsage --layout hybrid: aggregator=mean|sum|"
                         "max, lr=<float>; sampled graphsage and "
                         "graphsage_unsup: any SageConfig field, e.g. "
                         "fanouts=10,10, aggregator=max, "
                         "device_sampling=true; han: n_papers=<int>; "
                         "han_batch: batch_size, lr, patience; the walk "
                         "embedders, gatne and bine: any field of their "
                         "config, e.g. num_walks=10, device_walks=true, "
                         "loss=masked_bce")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="load a prior checkpoint before training")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--optimizer", choices=["adamw", "sgd"], default=None,
                    help="adamw (default) or the reference's SGD + "
                         "warmup-poly recipe")
    ap.add_argument("--layout", choices=["auto", "coo", "hybrid", "sparse"],
                    default="auto",
                    help="'auto' probes the clustered tile fill as the JAX "
                         "package does (GAT on Cora -> hybrid, GCN -> "
                         "coo); graphsage: 'hybrid' trains full-batch, "
                         "'auto'/'coo' the sampled pipeline; han: the "
                         "metapath graphs' layout; han_batch: auto or coo; "
                         "gtn: 'auto'/'coo' the dense model, 'sparse' "
                         "(gtn only) the wedge-plan composition")
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
    # JAX's gate (its cli.py ``_layout_models``), and the sampled
    # pipeline's unsupervised mode, which trains under any layout
    allowed = _LAYOUT_MODELS.get(args.layout)
    if allowed is not None and name not in allowed:
        ap.error(f"--layout {args.layout} is not supported for --model "
                 f"{name} (supported models: {', '.join(allowed)}; use "
                 "--layout auto or coo)")
    # a process group where torchrun or a coordinator started one (a no-op
    # in a single process); console logs come from the primary process
    # only, which alone writes checkpoints (train/checkpoint.py)
    from .parallel.multihost import initialize_distributed, is_primary
    initialize_distributed(device=args.device)
    args.quiet = args.quiet or not is_primary()
    if branch in ("graphsage", "graphsage_unsup"):
        return _sampled_sage(name, args)
    if name in ("han", "han_batch"):
        return _han(name, args, overrides)
    if name == "gtn":
        return _gtn(args)
    if name in _EMBEDDERS:
        return _embed(name, args)
    if name in _LINKPRED:
        return _linkpred(name, args)
    if name == "basis":
        from .analysis.demo import basis_demo
        from .core.device import resolve_device

        device = resolve_device(args.device)
        result = dict(basis_demo(device), device=str(device))
        print(json.dumps({"model": name, **result}))
        return result

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


def _han(name, args, overrides) -> dict:
    """HAN on the ACM (or IMDB) metapath graphs: full batch (``han``,
    ``train/han_loop.py``: ``test_acc``, ``seconds`` and, past one chunk,
    ``steady_epochs_per_s``) or on node minibatches (``han_batch``,
    ``train/han_batch.py``: ``test_acc``, ``val_acc``, ``batches``,
    ``seconds``)."""
    import torch

    from .core.device import resolve_device
    from .data import load_acm_han, load_imdb_han

    device = resolve_device(args.device)
    verbose = not args.quiet
    cdtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    epochs = args.epochs or 100
    if name == "han_batch":
        from .train.han_batch import fit_han_minibatch
        data = (load_imdb_han(seed=args.seed, device=device)
                if args.dataset == "imdb" else
                load_acm_han(path=args.dataset, seed=args.seed,
                             device=device))
        batch_size = int(overrides.get("batch_size", 32))
        res = fit_han_minibatch(
            data, batch_size=batch_size,
            lr=float(overrides.get("lr", 0.05)), epochs=epochs,
            patience=int(overrides.get("patience", 20)), seed=args.seed,
            verbose=verbose, dtype=cdtype)
        steps = max(1, -(-int(data.train_idx.numel()) // batch_size))
        epochs_run = -(-res.epochs_run // steps)
        result = dict(test_acc=res.test_acc, val_acc=res.best_val_acc,
                      batches=res.epochs_run, loss=res.history[-1][1],
                      epochs=epochs_run, seconds=res.seconds,
                      epochs_per_s=epochs_run / res.seconds,
                      device=str(device))
        print(json.dumps({"model": name, **result}))
        return result

    from .nn import HAN
    from .train.han_loop import fit_han
    from .train.schedule import make_optimizer

    data = (load_imdb_han(seed=args.seed, layout=args.layout, device=device)
            if args.dataset == "imdb" else
            load_acm_han(path=args.dataset, seed=args.seed,
                         layout=args.layout,
                         n_papers=int(overrides.get("n_papers", 600)),
                         device=device))
    model = HAN(int(data.features.shape[1]), num_metapaths=len(data.graphs),
                num_classes=data.num_classes, hidden=8, num_heads=(4,),
                dtype=cdtype)
    # --optimizer sgd: the reference's recipe, SGD lr 0.05 under warmup-poly
    opt_name = args.optimizer or "adamw"
    opt = make_optimizer(opt_name, 0.05 if opt_name == "sgd" else 5e-3,
                         total_steps=epochs, warmup_steps=1, momentum=0.9)
    res = fit_han(model, data, epochs=epochs, optimizer=opt,
                  epochs_per_call=min(20, epochs), seed=args.seed,
                  verbose=verbose)
    result = dict(test_acc=res.test_acc, loss=res.losses[-1],
                  epochs=res.epochs_run, seconds=res.seconds,
                  # includes the first chunk (kernel load, warm-up, capture)
                  epochs_per_s=res.epochs_run / res.seconds,
                  device=str(device))
    if res.steady_epochs_per_s is not None:
        result["steady_epochs_per_s"] = res.steady_epochs_per_s
    print(json.dumps({"model": name, **result}))
    return result


def _gtn(args) -> dict:
    """GTN on the ACM (or IMDB) edge-type stack, dense or over the wedge
    plan (``train/gtn_loop.py``): ``test_acc``, ``f1``, ``precision``,
    ``recall``, ``seconds`` and, past one chunk, ``steady_epochs_per_s``."""
    import torch

    from .core.device import resolve_device
    from .data import load_acm_gtn, load_imdb_gtn
    from .nn.gtn import GTN
    from .nn.gtn_sparse import (SparseGTN, build_gtn_plan,
                                stacked_adj_to_sparse)
    from .train.gtn_loop import fit_gtn

    device = resolve_device(args.device)
    data = (load_imdb_gtn(seed=args.seed, device=device)
            if args.dataset == "imdb" else
            load_acm_gtn(path=args.dataset, seed=args.seed, device=device))
    dims = dict(in_features=int(data.features.shape[1]),
                num_types=int(data.adj.shape[0]),
                num_classes=data.num_classes, channels=2, num_layers=2,
                hidden=64,
                dtype=torch.bfloat16 if args.dtype == "bfloat16" else None)
    if args.layout == "sparse":
        graph = build_gtn_plan(stacked_adj_to_sparse(data.adj),
                               int(data.adj.shape[1]), num_layers=2,
                               device=device)
        model = SparseGTN(**dims)
    else:
        graph, model = data.adj, GTN(**dims)
    epochs = args.epochs or 40
    res = fit_gtn(model, data, graph, epochs=epochs,
                  epochs_per_call=min(10, epochs), seed=args.seed,
                  verbose=not args.quiet)
    result = dict(test_acc=res.test_acc, f1=res.f1,
                  precision=res.precision, recall=res.recall,
                  loss=res.losses[-1], epochs=res.epochs_run,
                  seconds=res.seconds,
                  # includes the first chunk (warm-up, capture)
                  epochs_per_s=res.epochs_run / res.seconds,
                  device=str(device))
    if res.steady_epochs_per_s is not None:
        result["steady_epochs_per_s"] = res.steady_epochs_per_s
    print(json.dumps({"model": "gtn", "layout": args.layout, **result}))
    return result


def _embed(name, args) -> dict:
    """A walk embedder at the reference's defaults (``models/embedding.py``):
    JAX's ``final_loss``, ``initial_loss`` and ``embed_shape``, with the
    run's ``epochs`` and ``seconds`` (walks and corpus included)."""
    import time

    from .core.device import resolve_device
    from .data.edgelist import load_edgelist
    from .models import embedding

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if name == "metapath2vec":
        cfg = _apply_overrides(embedding.WalkEmbedConfig(
            window=4, num_negatives=4, batch_size=512,
            epochs=args.epochs or 5, seed=args.seed), args.set)
        graph = {}
        if args.dataset is not None:
            # the JData pipeline: a directory of processed CSVs, or the
            # loader's synthetic action table where it holds none
            from .data.jdata import load_jdata

            jd = load_jdata(args.dataset, seed=args.seed)
            graph = dict(hetero=jd.hetero, metapath=jd.metapath,
                         type_offsets=jd.type_offsets)
        emb, history = embedding.run_metapath2vec(cfg=cfg, device=device,
                                                  **graph)
    else:
        data = load_edgelist(path=args.dataset, seed=args.seed)
        config = {"line": embedding.LINEConfig,
                  "sdne": embedding.SDNEConfig}.get(
                      name, embedding.WalkEmbedConfig)
        cfg = _apply_overrides(config(
            epochs=args.epochs or (10 if name == "sdne" else 5),
            seed=args.seed), args.set)
        run = getattr(embedding, f"run_{name}")
        emb, history = run(data, cfg, device=device)
    result = dict(final_loss=history[-1][1], initial_loss=history[0][1],
                  embed_shape=list(emb.shape), epochs=len(history),
                  seconds=time.perf_counter() - t0, device=str(device))
    if not args.quiet:
        for row in history:
            print(f"epoch {row[0]}: loss {row[1]:.4f}")
    print(json.dumps({"model": name, **result}))
    return result


def _linkpred(name, args) -> dict:
    """GATNE on the multiplex graph or BiNE on the ratings: JAX's
    ``test_metrics`` (and for BiNE ``final_loss`` and ``initial_loss``),
    with the run's loss ends, ``epochs``, ``seconds`` (walks and corpus
    included) and ``device``."""
    import time

    from .core.device import resolve_device

    device = resolve_device(args.device)
    verbose = not args.quiet
    t0 = time.perf_counter()
    if name == "gatne":
        from .data.edgelist import load_multiplex
        from .models.gatne import GATNEConfig, train_gatne

        data = load_multiplex(root=args.dataset, seed=args.seed)
        cfg = _apply_overrides(
            GATNEConfig(epochs=args.epochs or 5, seed=args.seed), args.set)
        _, history, metrics = train_gatne(data, cfg, verbose=verbose,
                                          device=device)
    else:
        from .models.bine import BiNEConfig, train_bine

        cfg = _apply_overrides(
            BiNEConfig(epochs=args.epochs or 5, seed=args.seed), args.set)
        _, history, metrics = train_bine(cfg=cfg, verbose=verbose,
                                         device=device)
    result = dict(final_loss=history[-1][1], initial_loss=history[0][1],
                  test_metrics=metrics, epochs=len(history),
                  seconds=time.perf_counter() - t0, device=str(device))
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
