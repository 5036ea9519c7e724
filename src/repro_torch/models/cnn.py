"""Darknet-style CNN layer tables, parameters and batchnorm folding.

The jax-free counterpart of ``repro/models/cnn.py``.  Parameters keep the
reference's format: one dict per layer, conv weights HWIO ``(kh, kw, C, O)``
with either a ``bn`` dict (gamma, beta, mean, var) or a plain ``b`` bias,
fc weights ``(C, O)`` with ``b``.  ``init_cnn`` returns that list as numpy
arrays so the same draw can feed both packages; ``params_from_numpy`` turns
it into the port's tensors with no transposes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.conv_spec import ConvSpec


@dataclasses.dataclass(frozen=True)
class CNNLayer:
    kind: str                      # conv | maxpool | upsample | shortcut | route | avgpool | fc
    out_channels: int = 0
    kernel: int = 3
    stride: int = 1
    pad: Optional[int] = None      # None -> same-ish (kernel//2)
    batch_norm: bool = True
    activation: str = "leaky"      # leaky | relu | linear
    from_layers: Tuple[int, ...] = ()  # shortcut/route sources (indices)
    size: int = 2                  # pool size / upsample factor


def _conv_spec(layer: CNNLayer, in_ch: int) -> ConvSpec:
    pad = layer.pad if layer.pad is not None else layer.kernel // 2
    return ConvSpec(
        in_channels=in_ch,
        out_channels=layer.out_channels,
        kernel_size=(layer.kernel, layer.kernel),
        stride=(layer.stride, layer.stride),
        padding=(pad, pad),
    )


def layer_ref_spans(layers: Sequence[CNNLayer]) -> Tuple[Tuple[int, int], ...]:
    """Every (source, consumer) ``from_layers`` dependency span.

    A route/shortcut at index j consuming layer r needs r's output resident
    wherever j runs; a pipeline-stage cut between them (r < cut <= j) is
    illegal.  Returned sorted by consumer for stable downstream iteration.
    """
    return tuple(
        (r, j)
        for j, l in enumerate(layers)
        for r in getattr(l, "from_layers", ())
    )


def fold_batchnorm(params: Sequence[Dict], layers: Sequence[CNNLayer],
                   eps: float = 1e-5) -> List[Dict]:
    """Fold inference-mode batchnorm into conv weights + bias.

    bn(conv(x, w)) = conv(x, w * s) + (beta - mean * s) with
    s = gamma / sqrt(var + eps), so every conv layer reduces to
    conv + bias (+ activation) — the precondition for fusing the whole
    epilogue into the conv kernel's output stage.  Layers without bn pass
    through unchanged.
    """
    folded: List[Dict] = []
    for p, l in zip(params, layers):
        if l.kind == "conv" and "bn" in p:
            bn = p["bn"]
            s = bn["gamma"] * torch.rsqrt(bn["var"] + eps)       # (O,)
            folded.append({
                "w": p["w"] * s,                                 # (kh,kw,C,O)
                "b": bn["beta"] - bn["mean"] * s,
            })
        else:
            folded.append(p)
    return folded


def init_cnn(rng: np.random.Generator, layers: Sequence[CNNLayer],
             in_channels: int = 3) -> List[Dict[str, Any]]:
    """Random float32 numpy params in the reference's format.

    The same scales as the reference's ``init_cnn`` (conv weights
    N(0, 1/(k·sqrt(C))), fc weights N(0, 1/sqrt(C))) and its identity
    batchnorm statistics; the draw comes from ``rng``.
    """
    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    params: List[Dict[str, Any]] = []
    ch: List[int] = []
    cur = in_channels
    for l in layers:
        p: Dict[str, Any] = {}
        if l.kind == "conv":
            p["w"] = normal((l.kernel, l.kernel, cur, l.out_channels),
                            1.0 / (l.kernel * max(cur, 1) ** 0.5))
            o = l.out_channels
            if l.batch_norm:
                p["bn"] = {
                    "gamma": np.ones(o, np.float32),
                    "beta": np.zeros(o, np.float32),
                    "mean": np.zeros(o, np.float32),
                    "var": np.ones(o, np.float32),
                }
            else:
                p["b"] = np.zeros(o, np.float32)
            cur = o
        elif l.kind == "route":
            cur = sum(ch[j] for j in l.from_layers)
        elif l.kind == "fc":
            p["w"] = normal((cur, l.out_channels), 1.0 / cur ** 0.5)
            p["b"] = np.zeros(l.out_channels, np.float32)
            cur = l.out_channels
        params.append(p)
        ch.append(cur)
    return params


def random_batchnorm(params: Sequence[Dict[str, Any]],
                     rng: np.random.Generator) -> List[Dict[str, Any]]:
    """``params`` with random batchnorm statistics from ``rng`` in place of
    ``init_cnn``'s identity ones (gamma and var uniform in [0.5, 1.5), beta
    and mean N(0, 0.1^2)), so that folding really changes the weights."""
    out: List[Dict[str, Any]] = []
    for p in params:
        p = dict(p)
        if "bn" in p:
            o = p["bn"]["gamma"].shape[0]
            p["bn"] = {
                "gamma": rng.uniform(0.5, 1.5, o).astype(np.float32),
                "beta": (0.1 * rng.standard_normal(o)).astype(np.float32),
                "mean": (0.1 * rng.standard_normal(o)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, o).astype(np.float32),
            }
        out.append(p)
    return out


def params_from_numpy(params: Sequence[Dict[str, Any]],
                      device: Any = "cuda") -> List[Dict[str, Any]]:
    """The reference's parameter list (numpy arrays, or anything
    ``torch.as_tensor`` takes) as float32 tensors on ``device``.

    Layouts are kept as they are — HWIO conv weights, (C, O) fc weights —
    so no transposes happen and values are bit-identical.
    """
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=device)

    return [conv(dict(p)) for p in params]
