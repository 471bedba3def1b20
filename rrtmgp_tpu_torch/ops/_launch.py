"""Argument plumbing shared by the kernel wrappers: raw pointers and the
current stream for the ctypes calls, and the checks a wrapper makes before it
hands a tensor to a kernel."""

from __future__ import annotations

import ctypes

import torch


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t, name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape/dtype on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def cuda_device(t: torch.Tensor, name: str) -> torch.device:
    """The tensor's CUDA device; raises for any device other than CUDA."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device}; the kernel runs on CUDA, "
                         "the plain version on CPU")
    return t.device
