"""CLI: statically verify a zoo model's compiled plan.

    python -m repro_torch.analysis vgg16 --dtype int8 --level full
    python -m repro_torch.analysis yolov3-tiny --input-hw 128 128 --json
    python -m repro_torch.analysis vgg16 --device cpu --input-hw 32 32

Compiles the model in cost mode with seeded random weights (seed 0),
prepares the parameters exactly as the executor does, runs the verifier
and prints the report.  On the card (the default) the recorded forward
launches the CUDA kernels; ``--device cpu`` runs their plain versions
(``impl='torch'``), which record the same launches.  Exit status 1 on any
error finding.
"""
from __future__ import annotations

import argparse
import sys

MODELS = ("vgg16", "yolov3-tiny", "yolov3-20")


def _resolve_model(name: str):
    if name == "vgg16":
        from repro_torch.configs.vgg16 import MODEL

        return MODEL
    from repro_torch.configs.yolov3 import MODEL_20, TINY_MODEL

    return TINY_MODEL if name == "yolov3-tiny" else MODEL_20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static plan verifier over the config zoo")
    ap.add_argument("model", choices=MODELS)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16", "float16", "int8"))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--input-hw", type=int, nargs=2, metavar=("H", "W"),
                    help="override the model's input geometry (a reduced "
                         "size for a quick CPU run)")
    ap.add_argument("--level", default="full",
                    choices=("plan", "kernel", "full"),
                    help="'plan' = shared memory and layout decisions only "
                         "(no forward); 'kernel' = one recorded forward, its "
                         "launches against the plan's and the kernel passes "
                         "(race, bounds, accum, int8 overflow); 'full' = "
                         "everything")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the recorded forward runs: the card's "
                         "kernels (default) or their plain versions on the "
                         "CPU")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable report")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    import repro_torch
    from repro_torch.analysis import dump_json
    from repro_torch.api import ExecutionOptions
    from repro_torch.models.cnn import init_cnn

    model = _resolve_model(args.model)
    if args.input_hw:
        model = dataclasses.replace(model, input_hw=tuple(args.input_hw))
    params = init_cnn(np.random.default_rng(0), model.layers)
    opts = ExecutionOptions(
        impl="torch" if args.device == "cpu" else "cuda", device=args.device,
        batch=args.batch, dtype=args.dtype)
    compiled = repro_torch.compile(model, params, opts)
    report = compiled.verify_report(level=args.level)
    if args.json:
        print(dump_json(report))
    else:
        print(report.summary())
        for row in report.kernels:
            print("  step {step:>3} {kernel:<26} grid {grid!s:<16} "
                  "smem {smem_bytes:>7} B (model {smem_model_bytes}) "
                  "splits {splits} traffic {traffic_bytes} B".format(**row))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
