"""One design choice of GATNE's device loop (``models/gatne.py``), timed on
the card. Run from the repository root:

    python -m graphneuralnetwork_tpu_torch.tools.gatne_step [--loss nsloss]

GATNE picks each center's per-type attention and transform parameters
(``w_att``, ``v_att``, ``trans``) by its edge type. The port picks them by
a product with the one-hot types (``nn/embed.py:_by_type``); JAX indexes
them (``w_att[edge_type]``), whose backward in PyTorch is an index gather's
(``index_put_``'s sorted accumulation: with 2 types, two runs of ~256
rows a batch, each summed on one warp). At the CLI's defaults (the
400-node synthetic multiplex, batch 512, one epoch of the device loop:
warm-up step, capture, replays) each variant prints a captured step's
device ms (replays back to back behind a sleep kernel, ``time_ms``), its
costliest kernels (``kernel_ms``) and the epoch's mean loss.

Prints the card's name and power limit, then one JSON line a variant.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.edgelist import load_multiplex
from ..models import gatne
from ..nn import embed
from ..train.embed_loop import HostDrawnEpochs
from .timing import kernel_ms, time_ms

VARIANTS = {
    "one_hot": embed._by_type,
    "index": lambda pick, table: table[pick.argmax(dim=1)],
}


def measure(variant: str, loss: str, device: torch.device,
            steps: int = 20) -> dict:
    """One epoch of ``train_gatne``'s device loop with the parameters
    picked by ``variant``, then ``steps`` replays timed."""
    cfg = gatne.GATNEConfig(loss=loss)
    data = load_multiplex(seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    neighbors = torch.from_numpy(gatne.build_neighbor_tables(
        data, cfg.neighbor_samples, rng)).to(device)
    source = gatne._Batches(data, cfg, rng)
    params, opt = gatne.gatne_model(data, cfg, device)
    fn = gatne.masked_bce if loss == "masked_bce" else gatne.nsloss
    step = gatne.make_step(params, opt, fn, neighbors)
    arrays = source.epoch(rng, len(source) // cfg.batch_size)
    saved = embed._by_type
    embed._by_type = VARIANTS[variant]
    try:
        feed = HostDrawnEpochs(step, arrays, cfg.batch_size, opt, device)
        losses = feed.run(arrays)     # warm-up, capture, replays
    finally:
        embed._by_type = saved
    loop = feed.loop

    def replays():
        loop.index.zero_()
        for _ in range(steps):
            loop.graph.replay()

    total, top = kernel_ms(replays, top=4)
    return {"variant": variant, "loss": loss, "steps_per_epoch": loop.nb,
            "epoch_mean_loss": float(losses.astype(np.float64).mean()),
            "device_ms_per_step": time_ms(replays, reps=5, batch=1) / steps,
            "kernel_ms_per_step": total / steps,
            "top_kernels_ms_per_step": {k: v / steps
                                        for k, v in top.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loss", choices=["nsloss", "masked_bce"],
                    default="nsloss")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for variant in VARIANTS:
        print(json.dumps(measure(variant, args.loss, device)), flush=True)


if __name__ == "__main__":
    main()
