"""Operand checks and weight broadcasting shared by the kernel wrappers
(ops/pcg.py, ops/zncc.py, ops/fused_solver.py)."""

from __future__ import annotations

import torch


def check_operand(fn: str, name: str, t: torch.Tensor, device,
                  shape: tuple | None = None) -> None:
    """Raise unless `t` is what a float32 kernel takes: on `device`,
    float32, of `shape` (when given) and contiguous. `fn` names the wrapper
    in the message."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel is float32")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")


def per_problem(w, B: int, device, dtype=torch.float32) -> torch.Tensor:
    """(B,) per-problem weights from a scalar, a 0-d or a (B,) tensor;
    `dtype` None keeps a tensor's own."""
    return torch.as_tensor(w, dtype=dtype, device=device).reshape(-1).expand(B)


def weight_pairs(wf2, wr2, B: int, device) -> torch.Tensor:
    """The kernels' (B, 2) = (wf2, wr2) float32 weight table."""
    return torch.stack([per_problem(wf2, B, device),
                        per_problem(wr2, B, device)], dim=1).contiguous()
