"""Building blocks of the UNet: timestep embedding, fp32-statistics
GroupNorm (with the fused GN-apply+SiLU route to kernel K3), convolutions
with explicit compute dtypes, average pooling.

Port of ``fast_cwdm_tpu/models/nn.py``. Tensors are logical NCDHW; the
casts sit where the JAX package puts them, so bf16 rounds at the same
points.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fast_cwdm_tpu_torch.ops import elementwise_cuda


def timestep_embedding(
    timesteps: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """Sinusoidal embeddings in [cos | sin] order, always float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, output in the input dtype.

    Statistics mirror the JAX package (`nn.py:79-84`): per-channel
    E[x] and E[x²] over the spatial axes in one pass, group means of the
    channel means, var = max(E[x²] − E[x]², 0), eps 1e-5. ``act="silu"``
    applies SiLU in the same pass through kernel K3 (fp32 SiLU, one cast);
    the caller applies ``F.silu`` itself for the unfused path (bf16 SiLU
    after the cast), as the JAX package does.
    """

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, act: str | None = None) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float()
        spatial = tuple(range(2, x.dim()))
        mean_c = xf.mean(dim=spatial)  # (B, C)
        mean_sq_c = (xf * xf).mean(dim=spatial)
        mean = mean_c.reshape(b, g, c // g).mean(dim=-1)  # (B, G)
        mean_sq = mean_sq_c.reshape(b, g, c // g).mean(dim=-1)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        inv = torch.rsqrt(var + 1e-5)
        mean_pc = mean.repeat_interleave(c // g, dim=-1)  # (B, C)
        inv_pc = inv.repeat_interleave(c // g, dim=-1)
        if act == "silu":
            return elementwise_cuda.gn_apply_silu(
                x, mean_pc, inv_pc, self.weight, self.bias
            )
        if act is not None:
            raise ValueError(f"GroupNorm32: act must be None or 'silu', got {act!r}")
        bc = (b, c) + (1,) * (x.dim() - 2)
        scale = self.weight.reshape((1, c) + (1,) * (x.dim() - 2))
        shift = self.bias.reshape(scale.shape)
        y = (xf - mean_pc.reshape(bc)) * inv_pc.reshape(bc) * scale + shift
        return y.to(x.dtype)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` with symmetric padding and the JAX package's dtype
    rule: input, weight and bias are cast to ``dtype``; with ``dtype=None``
    the compute dtype is the promotion of the input's and the weight's
    (flax ``nn.Conv``: a bf16 input meets fp32 params in fp32)."""

    def __init__(self, in_ch, out_ch, kernel=3, *, stride=1, dtype=None,
                 zero_init=False, follow_input=False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2)
        self.compute_dtype = dtype
        # FusableConv3d's rule (`unet.py:190`): None follows the input
        self.follow_input = follow_input
        if zero_init:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            dt = x.dtype if self.follow_input else torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv3d(
            x.to(dt), self.weight.to(dt), self.bias.to(dt),
            self.stride, self.padding,
        )


def conv_nd(in_ch: int, out_ch: int, kernel: int = 3, *, dims: int = 3, stride=1,
            dtype=None, zero_init: bool = False) -> Conv3d:
    """3-D convolution with torch-style symmetric padding."""
    if dims != 3:
        raise NotImplementedError("the port implements dims=3 only")
    return Conv3d(in_ch, out_ch, kernel, stride=stride, dtype=dtype, zero_init=zero_init)


def avg_pool_nd(x: torch.Tensor, window) -> torch.Tensor:
    """Average pooling over the spatial dims, accumulated in float32 and
    rounded once to ``x``'s dtype, in ``x``'s memory format."""
    fmt = (
        torch.channels_last_3d
        if x.is_contiguous(memory_format=torch.channels_last_3d)
        else torch.contiguous_format
    )
    return F.avg_pool3d(x.float(), tuple(window)).to(x.dtype, memory_format=fmt)
