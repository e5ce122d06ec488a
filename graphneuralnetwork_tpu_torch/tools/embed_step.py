"""Two design choices of the skip-gram device loop (``train/embed_loop.py``),
timed on the card. Run from the repository root:

    python -m graphneuralnetwork_tpu_torch.tools.embed_step [--epochs 3]

  padding  DeepWalk's corpus at the CLI's defaults (the 500-node synthetic
           small world, 80 walks of 10 a node, subsampled: 222 steps of 256
           rows x 60 slots). One captured step with the padded slots at id
           0, as ``batchify`` leaves them, against ``spread_padding``'s
           slots (the port's design): the share of slots at id 0, a
           captured step's device ms (replays back to back behind a sleep
           kernel, ``time_ms``), its costliest kernels (``kernel_ms``), and
           whether ``--epochs`` captured epochs are bit-equal to eager
           ones.
  graph    Struc2Vec's corpus (no subsampling: 1,562 steps an epoch). One
           captured step replayed a batch (``CapturedEpochs``, the port's
           design) against the whole epoch captured as one ``EpochGraph``,
           from the same weights and generator seed: each of ``--epochs``
           epochs' wall ms a step (the whole epoch's first is its eager
           warm-up, its second its capture and one replay), a replayed
           epoch's device ms a step, and whether the two loops are
           bit-equal epoch for epoch.

Prints the card's name and power limit, then one JSON line a comparison.
``corpus`` builds the corpus that ``run_deepwalk`` or ``run_struc2vec``
trains on.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.edgelist import EdgeListData, load_edgelist
from ..models.embedding import WalkEmbedConfig
from ..nn.embed import SkipGram
from ..sampling.skipgram import skipgram_dataset
from ..sampling.struc2vec import Struc2VecWalker, build_multilayer_graph
from ..sampling.walks import csr_from_edges, uniform_walks
from ..train import embed_loop
from ..train.scan_loop import EpochGraph
from .timing import kernel_ms, time_ms


def corpus(model: str, data: EdgeListData,
           cfg: WalkEmbedConfig = WalkEmbedConfig()) -> tuple:
    """(centers, ctx_neg, labels, mask) as ``run_deepwalk`` (``model``
    "deepwalk") or ``run_struc2vec`` ("struc2vec", ``k_max`` 3, stay
    probability 0.3) build them from ``data`` and ``cfg``."""
    rng = np.random.default_rng(cfg.seed)
    indptr, indices, _ = csr_from_edges(data.senders, data.receivers,
                                        data.n_nodes)
    starts = np.tile(np.arange(data.n_nodes), cfg.num_walks)
    if model == "deepwalk":
        walks = uniform_walks(indptr, indices, starts, cfg.walk_length, rng)
        rng, subsample_t = np.random.default_rng(cfg.seed), cfg.subsample_t
    else:
        layers = build_multilayer_graph(indptr, indices, data.n_nodes,
                                        k_max=3)
        walks = Struc2VecWalker(layers, stay_prob=0.3).walk(
            starts, cfg.walk_length, rng)
        subsample_t = None
    return skipgram_dataset(walks, data.n_nodes, window=cfg.window,
                            num_negatives=cfg.num_negatives, rng=rng,
                            subsample_t=subsample_t)


def _loop(arrays, vocab: int, device: torch.device, spread: bool = True):
    """A SkipGram over ``vocab`` ids from ``_init_params(model, 0)`` and
    its ``CapturedEpochs`` over ``arrays`` on ``device``, as
    ``train_skipgram`` builds them at the CLI's defaults; with ``spread``
    False the padded slots keep id 0."""
    model = SkipGram(vocab, 128)
    embed_loop._init_params(model, 0)
    model.to(device)
    opt = embed_loop.make_adam(model.parameters(), 2e-3, device)
    if spread:
        return embed_loop.skipgram_epochs(
            model, opt, embed_loop.skipgram_loss, arrays, 256, 0,
            device), model
    gen = torch.Generator(device=device).manual_seed(0 ^ 0x5F5E)
    dev = [embed_loop._to_device(a, device) for a in arrays]
    return embed_loop.CapturedEpochs(
        embed_loop.batch_step(model, opt, embed_loop.skipgram_loss, dev),
        len(arrays[0]), 256, 2, opt, gen, device), model


class WholeEpoch:
    """``run()`` as ``loop.run()``, with the whole epoch of ``loop``
    captured as one graph: the first epoch runs eagerly on a side stream
    (the warm-up), the second is captured and replayed once, later ones
    only replay."""

    def __init__(self, loop: embed_loop.CapturedEpochs):
        self.loop, self.epochs = loop, 0
        self.graph = EpochGraph(loop.device)

    def run(self) -> np.ndarray:
        loop = self.loop
        loop._shuffle()
        if self.epochs == 0:
            self.graph.warm_up(lambda: loop.steps(loop.nb))
        else:
            if self.epochs == 1:
                # the captured backward allocates the step's gradients anew
                loop.optimizer.zero_grad(set_to_none=True)
                self.graph.capture(lambda: loop.steps(loop.nb))
            self.graph.replay()
        self.epochs += 1
        return loop._read()

    def replay(self) -> None:
        self.loop.index.zero_()
        self.graph.replay()


def _epochs(run, model, epochs: int) -> tuple:
    """(the rows of ``epochs`` calls of ``run``, a copy of ``model``'s
    parameters after them)."""
    rows = [run() for _ in range(epochs)]
    return rows, {k: v.clone() for k, v in model.state_dict().items()}


def _bit_equal(a, b) -> bool:
    """Bit-equal rows and parameters of two ``_epochs`` runs."""
    (rows_a, params_a), (rows_b, params_b) = a, b
    return (all(np.array_equal(x, y) for x, y in zip(rows_a, rows_b))
            and all(torch.equal(v, params_b[k]) for k, v in params_a.items()))


def _replays(loop: embed_loop.CapturedEpochs, n: int):
    """``n`` replays of ``loop``'s captured step from batch 0."""
    def run():
        loop.index.zero_()
        for _ in range(n):
            loop.graph.replay()
    return run


def padding(arrays, vocab: int, device: torch.device,
            epochs: int) -> list[dict]:
    """The ``padding`` comparison: one line a design."""
    ctx, mask = torch.from_numpy(arrays[1]), torch.from_numpy(arrays[3])
    out = []
    for spread in (False, True):
        runs = []
        for captured in (False, True):    # the captured loop is timed
            loop, model = _loop(arrays, vocab, device, spread)
            runs.append(_epochs(loop.run if captured else loop.run_eager,
                                model, epochs))
        ids = embed_loop.spread_padding(ctx, mask, vocab) if spread else ctx
        n = min(5, loop.nb)
        total, top = kernel_ms(_replays(loop, n), top=4)
        out.append({"comparison": "padding",
                    "design": "spread" if spread else "id_0",
                    "steps_per_epoch": loop.nb,
                    "id_0_share": float((ids == 0).double().mean()),
                    "device_ms_per_step": time_ms(_replays(loop, 1),
                                                  reps=5, batch=20),
                    "kernel_ms_per_step": total / n,
                    "top_kernels_ms": {k: v / n for k, v in top.items()},
                    "captured_vs_eager_bit_equal": _bit_equal(*runs)})
    return out


def graph(arrays, vocab: int, device: torch.device, epochs: int) -> dict:
    """The ``graph`` comparison: one step a graph against the whole
    epoch, in one line."""
    out, runs = {"comparison": "graph"}, {}
    for design in ("step", "epoch"):
        loop, model = _loop(arrays, vocab, device)
        if design == "step":
            run, replay = loop.run, _replays(loop, loop.nb)
        else:
            whole = WholeEpoch(loop)
            run, replay = whole.run, whole.replay
        ms = []

        def timed(run=run):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = run()
            ms.append((time.perf_counter() - t) * 1e3 / loop.nb)
            return rows

        runs[design] = _epochs(timed, model, epochs)
        out[design] = {"steps_per_epoch": loop.nb, "wall_ms_per_step": ms,
                       "device_ms_per_step": time_ms(replay, reps=3,
                                                     batch=1) / loop.nb}
    out["bit_equal"] = _bit_equal(runs["step"], runs["epoch"])
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}),
          flush=True)
    data = load_edgelist(seed=0)
    lines = padding(corpus("deepwalk", data), data.n_nodes, device,
                    args.epochs)
    lines.append(graph(corpus("struc2vec", data), data.n_nodes, device,
                       args.epochs))
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
