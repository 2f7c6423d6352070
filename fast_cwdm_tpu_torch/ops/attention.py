"""The attention product of ``models/unet.py::AttentionBlock``: softmax(q·kᵀ)·v
over the flattened positions, with q and k already split into heads.

Two routes, one contract: ``attention(q, k, v, scale)`` takes q, k and v
as (B, T, heads, ch) in the compute dtype and ``scale`` (1/√√ch rounded to
that dtype), and returns (B, T, heads, ch). Both scale q and k by
``scale`` in the compute dtype, as the JAX package does, and take the
softmax's statistics in fp32.

- **fused** (:func:`fused_ok`): a CUDA tensor in bf16 or fp16, with no
  autograd recording, no sp axis and a head size the flash backend takes.
  ``F.scaled_dot_product_attention`` with ``scale=1.0`` on (B, heads, T,
  ch) views, held to the flash backend (:func:`sdpa`): the (heads, T, T)
  matrix is never built, and a shape the backend refuses raises rather
  than falling back to a backend that would build it. The weights are cast
  to the compute dtype before ·v, as in the JAX package; the logits are
  not rounded to it before the softmax (they stay in the kernel's fp32
  accumulators), where the JAX package rounds them (PARITY.md).
- **plain** (:func:`plain`): everything else (the CPU, fp32, training
  under autograd, an sp axis): the JAX package's einsums, the whole
  matrix per sample.

``attention.launches`` counts the fused calls (``ops.launch_counts()
["attention"]``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fast_cwdm_tpu_torch.parallel.mesh import current_sp

FUSED_DTYPES = (torch.bfloat16, torch.float16)
MAX_HEAD_CHANNELS = 256  # the flash backend's largest head size


def fused_ok(q: torch.Tensor) -> bool:
    """Whether ``q`` (B, T, heads, ch) takes the fused route."""
    ch = q.shape[-1]
    return (q.is_cuda and q.dtype in FUSED_DTYPES
            and not (torch.is_grad_enabled() and q.requires_grad)
            and current_sp() is None and ch % 8 == 0 and ch <= MAX_HEAD_CHANNELS)


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The whole (B, heads, T, T) logits in the compute dtype, their
    softmax in fp32 cast back, then ·v (the JAX package's order)."""
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
    weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    return torch.einsum("bhts,bshc->bthc", weights, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         backend=None) -> torch.Tensor:
    """The fused route's arithmetic: q·s and k·s in the compute dtype, then
    ``F.scaled_dot_product_attention(..., scale=1.0)`` held to ``backend``
    (default the flash backend; the tests run it through the math backend
    on the CPU)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION if backend is None else backend):
        out = F.scaled_dot_product_attention(
            (q * scale).transpose(1, 2), (k * scale).transpose(1, 2), v.transpose(1, 2),
            scale=1.0)
    return out.transpose(1, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q·s·(k·s)ᵀ)·v of (B, T, heads, ch) tensors, on the route
    :func:`fused_ok` picks."""
    if fused_ok(q):
        attention.launches += 1
        return sdpa(q, k, v, scale)
    return plain(q, k, v, scale)


attention.launches = 0
