"""AdamW with global-norm clipping and fp32, bf16 or int8 (block-quantized)
moments: the port of ``repro/optim/adamw.py``.

The state mirrors the parameter tree (the port's: per-layer dicts in a
list).  ``update`` is functional, as the reference's, and reads nothing
back to the host: the step counter, the learning rate, the norm and the
clip factor stay device tensors and no Python branch looks at one, so a
train step around it can be captured as a CUDA graph.

Weight decay follows the rule the reference's comment states, "no decay
on norms": a leaf is decayed when it is 2-D or more *as a per-layer
leaf*.  The reference stacks each period's layers along a leading axis
(``scan_layers``), so there every 1-D per-layer leaf (the norms, qwen's
QKV biases, the RG-LRU's vectors) is 2-D and decayed, while the same
leaves of its unstacked tail and ``final_norm`` are not.  The port keeps
its layers unstacked and decays none of them (a reference fault not
copied; ``tests/test_torch_optim.py`` shows both).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.optim.quantized_state import dequantize, quantize

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, on the parameters' device
    m: Any
    v: Any

    # A tree node of repro_torch.tree: fields named as the reference's
    # pytree flattening names a NamedTuple's (".step").
    def tree_children(self):
        return [(".step", self.step), (".m", self.m), (".v", self.v)]

    def tree_rebuild(self, values) -> "AdamWState":
        return AdamWState(*values)


def _store(x: torch.Tensor, moment_dtype: str):
    if moment_dtype == "int8":
        return quantize(x)
    return x.to(_MOMENT_DTYPES[moment_dtype])


def _load(x, moment_dtype: str) -> torch.Tensor:
    if moment_dtype == "int8":
        return dequantize(x)
    return x.to(torch.float32)


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` and step 0, beside the params."""
    if cfg.moment_dtype not in (*_MOMENT_DTYPES, "int8"):
        raise ValueError(f"moment_dtype must be float32, bfloat16 or int8, "
                         f"got {cfg.moment_dtype!r}")

    def zeros(p):
        return _store(torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), cfg.moment_dtype)

    device = tree_lib.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_lib.tree_map(zeros, params),
                      v=tree_lib.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_lib.leaves(tree)))


def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           grad_norm: Optional[torch.Tensor] = None
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new params, new state, metrics).

    ``grad_norm``: the global norm to clip by, where ``grads`` are a
    slice of the gradients (ZeRO, ``distributed/zero.py``); by default
    ``global_norm(grads)``."""
    step = state.step + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = (cfg.grad_clip_norm / gnorm.clamp_min(1e-9)).clamp(max=1.0)
    lr = cfg.lr(step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf

    def leaf(p, g, m_q, v_q):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * _load(m_q, cfg.moment_dtype) + (1 - cfg.b1) * g
        v = cfg.b2 * _load(v_q, cfg.moment_dtype) + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0  # no decay on norms
        new_p = pf - lr * (upd + decay * pf)
        return (new_p.to(p.dtype), _store(m, cfg.moment_dtype),
                _store(v, cfg.moment_dtype))

    # A tuple is a leaf of repro_torch.tree: one (p, m, v) a parameter.
    outs = tree_lib.tree_map(leaf, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_lib.tree_map(lambda o, i=i: o[i], outs)
                           for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, AdamWState(step=step, m=new_m, v=new_v), metrics
