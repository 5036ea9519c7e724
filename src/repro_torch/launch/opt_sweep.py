"""Optimized full sweep: the reference's validated configuration per arch
(``repro/launch/opt_sweep.py``'s ``overrides_for``, copied) applied to
every runnable cell of the port's dry run (tag 'opt').

    PYTHONPATH=src python -m repro_torch.launch.opt_sweep --mesh single

The recipe, as the reference states it:
  - bf16 Adam moments for >5B archs
  - chunked-vocab cross-entropy for vocab >= 49k
  - DP-only sharding for <2.5B-param dense archs whose train batch covers
    every chip; data x sequence parallelism for their prefill
  - masked scatter-add MoE dispatch with DP sharding
  - grad_accum=8 on big-model train cells
  - remat stays 'full'
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import RESULTS_DIR, run_cell

SMALL = 2.5e9


def overrides_for(arch: str, shape_name: str, chips: int = 256) -> dict:
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    o: dict = {}
    big = cfg.param_count() > 5e9
    small = cfg.param_count() < SMALL
    kind = shape.kind
    if kind == "train":
        o["moment_dtype"] = "bfloat16" if big else "float32"
        if cfg.vocab_size >= 49152:
            o["loss_vocab_chunk"] = 1024
        if big:
            o["grad_accum"] = 8
    if cfg.num_experts:
        o["moe_sharded_dispatch"] = True
    if small and not cfg.num_experts:
        if kind == "train" and shape.global_batch % chips == 0:
            o["sharding_mode"] = "dp_only"
        elif kind == "prefill":
            o["sharding_mode"] = "dp_seq"
    return o


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--arch", action="append", default=None,
                    help="only these archs (repeatable; default: all)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for arch in args.arch or configs.ARCHS:
        for shape_name in SHAPES:
            for mk in meshes:
                o = overrides_for(arch, shape_name,
                                  chips=512 if mk == "multi" else 256)
                run_cell(arch, shape_name, mk, o, "opt", args.out,
                         skip_existing=args.skip_existing)


if __name__ == "__main__":
    main()
