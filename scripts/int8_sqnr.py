#!/usr/bin/env python3
"""int8 against fp32: the output SQNR of the PyTorch port and of the JAX
reference, on the CPU, under four setups of weights and calibration.

For each model (YOLOv3-tiny and VGG-16 at full channel widths, at a small
input size) and each seed, the weights come from ``init_cnn`` with either
its identity batchnorm statistics or ``random_batchnorm``'s, and int8 is
calibrated either on the input itself or on a separate batch of two images
drawn from the same distribution (held out).  Each line gives, on the same
weights and input:

  port      int8 vs fp32 of ``repro_torch.compile`` (impl='torch', the
            kernels' plain versions);
  ref       int8 vs fp32 of ``repro.compile`` (impl='jax');
  port/ref  the two int8 outputs against each other.

The chip's int8 cells gate the identity-batchnorm, calibrate-on-the-input
setup at 30 dB (int8 vs fp32), as the reference's acceptance test does;
this script shows where the other setups sit.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/int8_sqnr.py \\
        [--hw 32] [--seeds 0 1 2] [--models yolov3-tiny vgg16]
"""
from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

import repro
import repro_torch
from repro.configs import vgg16 as jvgg16
from repro.configs import yolov3 as jyolov3
from repro_torch.configs import vgg16, yolov3
from repro_torch.core.quant import sqnr_db
from repro_torch.models.cnn import init_cnn, random_batchnorm

MODELS = {"yolov3-tiny": (yolov3.TINY_MODEL, jyolov3.TINY_MODEL),
          "vgg16": (vgg16.MODEL, jvgg16.MODEL)}


def _port(model, params, x, dtype, calibration=None):
    opts = repro_torch.ExecutionOptions(impl="torch", device="cpu",
                                        dtype=dtype)
    return repro_torch.compile(model, params, opts,
                               calibration=calibration).run(x).numpy()


def _ref(model, params, x, dtype, calibration=None):
    opts = repro.ExecutionOptions(impl="jax", dtype=dtype, cache_path=None)
    cal = None if calibration is None else jnp.asarray(calibration)
    return np.asarray(repro.compile(model, params, opts,
                                    calibration=cal).run(jnp.asarray(x)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--models", nargs="+", default=list(MODELS),
                    choices=list(MODELS))
    args = ap.parse_args()
    hw = (args.hw, args.hw)
    print("model seed batchnorm calibration: SQNR dB port | ref | port/ref")
    for name in args.models:
        ours, theirs = MODELS[name]
        model = repro_torch.CNNModel(ours.layers, hw, name=name)
        ref_model = theirs.with_input_hw(hw)
        for seed in args.seeds:
            rng = np.random.default_rng(seed)
            base = init_cnn(rng, model.layers)
            bn = {"identity": base, "random": random_batchnorm(base, rng)}
            x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
            held_out = rng.standard_normal((2, *hw, 3)).astype(np.float32)
            for bn_name, params in bn.items():
                p32 = _port(model, params, x, "float32")
                r32 = _ref(ref_model, params, x, "float32")
                for cal_name, cal in (("input", x), ("held-out", held_out)):
                    p8 = _port(model, params, x, "int8", cal)
                    r8 = _ref(ref_model, params, x, "int8", cal)
                    print(f"{name} {seed} {bn_name} {cal_name}: "
                          f"{sqnr_db(p32, p8):.2f} | {sqnr_db(r32, r8):.2f} | "
                          f"{sqnr_db(r8, p8):.2f}", flush=True)


if __name__ == "__main__":
    main()
