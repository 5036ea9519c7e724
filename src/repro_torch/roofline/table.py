"""The (arch x shape x mesh) roofline table from the dry run's JSONs: the
port's counterpart of the reference's ``benchmarks/lm_roofline.py``.

    python -m repro_torch.roofline.table [--dir build/dryrun_torch] [--tag opt] [--markdown]

One row per cell: the three roofline terms on the H100, the dominant
bound, the roofline fraction, the useful-FLOPs ratio and GiB per device.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

DEFAULT_DIR = os.path.join("build", "dryrun_torch")

HEADER = ("| arch | shape | mesh | compute_s | memory_s | collective_s |"
          " dominant | frac | useful | GiB/dev |")


def load_cells(results_dir: str = DEFAULT_DIR, tag: Optional[str] = None):
    """Every cell's JSON, its file name's tag (the part after a third
    ``__``, '' without) as ``_tag``; only those of ``tag`` if given."""
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        parts = os.path.basename(path)[:-5].split("__")
        r["_tag"] = parts[3] if len(parts) > 3 else ""
        if tag is None or r["_tag"] == tag:
            cells.append(r)
    return cells


def rows(cells, markdown: bool = False) -> List[str]:
    out = [HEADER, "|---|---|---|---|---|---|---|---|---|---|"] if markdown else []
    for r in cells:
        mesh = r.get("mesh", "-")
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} | skipped: "
                       f"{r['reason']} |||||||" if markdown else
                       f"lm/{r['arch']}/{r['shape']}/{mesh} skipped: {r['reason']}")
            continue
        if "error" in r:
            out.append(f"lm/{r['arch']}/{r['shape']}/{mesh} error: {r['error'][:60]}")
            continue
        rl = r["roofline"]
        gib = r["memory"]["total_per_device_gib"]
        if markdown:
            out.append(f"| {r['arch']} | {r['shape']} | {mesh} |"
                       f" {rl['compute_s']:.4f} | {rl['memory_s']:.4f} |"
                       f" {rl['collective_s']:.4f} | {rl['dominant']} |"
                       f" {rl['roofline_frac']:.3f} | {rl['useful_flops_ratio']:.2f} |"
                       f" {gib:.1f} |")
        else:
            out.append(f"lm/{r['arch']}/{r['shape']}/{mesh} compute_s="
                       f"{rl['compute_s']:.6g} memory_s={rl['memory_s']:.6g} "
                       f"collective_s={rl['collective_s']:.6g} dominant="
                       f"{rl['dominant']} frac={rl['roofline_frac']:.3f} useful="
                       f"{rl['useful_flops_ratio']:.2f} gib_per_device={gib:.3f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--tag", default="", help="cells of this tag ('' = untagged)")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    print("\n".join(rows(load_cells(args.dir, args.tag), args.markdown)))


if __name__ == "__main__":
    main()
