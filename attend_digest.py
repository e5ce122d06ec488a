#!/usr/bin/env python3
"""Digests of the hybrid attend kernels' outputs (K4-K6 and K8-K10), so
that two checkouts can be compared bit for bit on one CUDA card. Run from
a checkout's root:

    python3 attend_digest.py --save a.json [--tree DIR]
    python3 attend_digest.py --compare a.json b.json

``--save`` runs every kernel once at each of the attend shapes of
``chip_smoke.attend_shapes`` (of the checkout it imports), float32 and
bfloat16, dropout off and on, on operands drawn from a seed of their own
per case, and writes the SHA-256 of every output's bytes. K10's seeds are
drawn too, not taken from K8, so that K10 compares bit for bit where K8
differs. It needs a CUDA card. ``--tree DIR`` imports the port and
``chip_smoke.py`` from another checkout (its kernels are built there):
run this script from one checkout for both trees. ``--compare`` prints,
per kernel, how many outputs match bit for bit and which do not, over the
cases both files hold, and exits 1 if any kernel but K8 and K9 differs
(their walk sums in another order than the lane-group design it replaced;
K10, K4, K5 and K6 must match bit for bit).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

#: Kernels whose outputs may differ between the trees compared.
MAY_DIFFER = ("K8", "K9")


def _digest(t: torch.Tensor) -> str:
    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def save(path: str) -> None:
    import chip_smoke as cs
    from graphneuralnetwork_tpu_torch.data import load_cora
    from graphneuralnetwork_tpu_torch.ops import bcsr_attention
    from graphneuralnetwork_tpu_torch.ops.cuda import attend_bwd_kernel as k56
    from graphneuralnetwork_tpu_torch.ops.cuda import attend_online_kernel as k4
    from graphneuralnetwork_tpu_torch.ops.cuda import attend_parts_kernel as k910
    from graphneuralnetwork_tpu_torch.ops.cuda import rem_attend_kernel as k8

    cora = load_cora(seed=0, layout="auto", layout_objective="attention",
                     device="cuda", model="gat").graph
    shapes = cs.attend_shapes(cora, cs._hub_hybrid(), cs._large_hybrid())
    out = {}
    for case, (label, graph, heads, feat, _) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            hg = cs._with_tile_dtype(graph, dtype)
            for dropping in (False, True):
                gen = torch.Generator(device="cuda").manual_seed(case)
                n = hg.n_nodes

                def randn(*shape):
                    return torch.randn(*shape, device="cuda", generator=gen)

                x, gn = randn(n, heads * feat).to(dtype), randn(
                    n, heads * feat).to(dtype)
                fs, fd, dden = randn(n, heads), randn(n, heads), randn(
                    n, heads)
                kp = 0.4 if dropping else 1.0
                bits, keep_mul = (bcsr_attention.draw_dropout(hg, heads, kp,
                                                              gen)
                                  if dropping else (None, None))
                o, den, m = k4.attend_online(hg, x, fs, fd, bits, keep_mul,
                                             0.2, kp)
                fdm3 = torch.cat([fd, torch.where(den > 0, m, 0.0), dden], 1)
                bwd = (hg, x, gn, fs, fdm3, bits, keep_mul, 0.2, kp)
                dfd = k56.attend_bwd_a(*bwd)
                dx, dfs = k56.attend_bwd_b(*bwd)
                shift = bcsr_attention.three_pass_shift(hg, fs, fd, 0.2)
                num, pden = k8.rem_attend(hg, x, fs, fd, shift, keep_mul, 0.2)
                tnum, tden = k910.tile_parts(hg, x, fs, fd, shift, bits, 0.2,
                                             kp)
                seed_num = randn(n, heads * feat)
                seed_den = torch.rand(n, heads, device="cuda", generator=gen)
                fout, fden = k910.attend_fused(hg, x, fs, fd, shift, seed_num,
                                               seed_den, bits, 0.2, kp)
                torch.cuda.synchronize()
                key = (f"{label} {str(dtype)[6:]} {heads}x{feat} "
                       f"dropout={dropping}")
                out[key] = {"K4": [_digest(t) for t in (o, den, m)],
                            "K5": [_digest(dfd)],
                            "K6": [_digest(t) for t in (dx, dfs)],
                            "K8": [_digest(t) for t in (num, pden)],
                            "K9": [_digest(t) for t in (tnum, tden)],
                            "K10": [_digest(t) for t in (fout, fden)]}
    with open(path, "w") as fh:
        json.dump({"device": torch.cuda.get_device_name(0), "cases": out},
                  fh, indent=1)
    print(json.dumps({"saved": path, "cases": len(out)}))


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as fh:
        a = json.load(fh)["cases"]
    with open(b_path) as fh:
        b = json.load(fh)["cases"]
    report = {}
    for key in sorted(set(a) & set(b)):
        for kern, digests in a[key].items():
            r = report.setdefault(kern, {"identical": 0, "differ": []})
            if digests == b[key][kern]:
                r["identical"] += 1
            else:
                r["differ"].append(key)
    print(json.dumps({"compare": [a_path, b_path], "kernels": report}))
    return int(any(r["differ"] for k, r in report.items()
                   if k not in MAY_DIFFER))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save")
    ap.add_argument("--tree")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        sys.exit(compare(*args.compare))
    if args.tree:
        sys.path.insert(0, args.tree)
    if not torch.cuda.is_available():
        sys.exit("attend_digest: no CUDA device")
    save(args.save)


if __name__ == "__main__":
    main()
