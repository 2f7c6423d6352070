"""Building blocks of the UNet: timestep embedding, fp32-statistics
GroupNorm (with the fused GN-apply+SiLU route to kernel K3), 1-, 2- and
3-D convolutions with explicit compute dtypes, average pooling.

Port of ``fast_cwdm_tpu/models/nn.py``. Tensors are logical NCL, NCHW or
NCDHW; the casts sit where the JAX package puts them, so bf16 rounds at
the same points.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from fast_cwdm_tpu_torch.ops import elementwise_cuda
from fast_cwdm_tpu_torch.parallel.mesh import (
    TpAxis,
    all_gather_tp,
    all_reduce_sum_sp,
    current_sp,
    global_sum_sp,
    halo_pad,
    tp_copy,
    tp_shard_axis,
)


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


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims. Under an active sp axis ``x`` is this
    rank's slab: the mean of the whole volume, every rank holding it and
    backpropagating it as a loss (``global_sum_sp``)."""
    dims = tuple(range(1, x.dim()))
    if current_sp() is None:
        return x.mean(dim=dims)
    sums = global_sum_sp(torch.stack(
        [x.sum(dim=dims), torch.full(x.shape[:1], float(x[0].numel()), device=x.device)], -1))
    return sums[..., 0] / sums[..., 1]


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, output in the input dtype.

    Statistics mirror the JAX package (`nn.py:79-84`): per-channel
    E[x] and E[x²] over the spatial axes in one pass, group means of the
    channel means, var = max(E[x²] − E[x]², 0), eps 1e-5; under an active
    sp axis the channel means are the volume's (sums over the slab and the
    voxel count, summed over the group). ``act="silu"``
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
        # a (B, C) input has no spatial axes: its channel means are itself
        # (torch reads an empty ``dim`` as every axis)
        if spatial and current_sp() is not None:
            # this rank's slab: channel sums and the voxel count, summed
            # over the sp group in one all-reduce
            count = torch.full((b, 1), float(xf[0, 0].numel()), device=x.device)
            sums = all_reduce_sum_sp(
                torch.cat([xf.sum(dim=spatial), (xf * xf).sum(dim=spatial), count], dim=1))
            mean_c, mean_sq_c = sums[:, :c] / sums[:, -1:], sums[:, c:2 * c] / sums[:, -1:]
        else:
            mean_c = xf.mean(dim=spatial) if spatial else xf  # (B, C)
            mean_sq_c = (xf * xf).mean(dim=spatial) if spatial else xf * xf
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


class _ComputeDtype:
    """The JAX package's dtype rule for a convolution: input, weight and
    bias are cast to ``dtype``; with ``dtype=None`` the compute dtype is the
    promotion of the input's and the weight's (flax ``nn.Conv``: a bf16
    input meets fp32 params in fp32), or the input's with
    ``follow_input``. Symmetric padding, as torch's. A 3-D conv under an
    active sp axis pads Y with its neighbours' planes (``halo_pad``); a 1×1
    conv stays local. A weight that holds a tp slice of the output channels
    (``shard_params``) computes them from the input its groups read and
    gathers them over the tp axis; the bias, replicated, is added to the
    gathered output, so that its gradient is whole on every rank, and the
    input's gradient is summed over the tp group (``tp_copy``)."""

    def __init__(self, in_ch, out_ch, kernel=3, *, stride=1, groups=1, dtype=None,
                 zero_init=False, follow_input=False):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2,
                         groups=groups)
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
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        tp = tp_shard_axis(w.shape[0], self.out_channels)
        padding = self.padding
        pad = self.padding[1] if len(self.padding) == 3 else 0
        if current_sp() is not None and pad:
            # x is this rank's Y slab: the neighbours' planes as the Y
            # padding (zeros at the volume's edges), no padding of the
            # conv's own in Y
            x = halo_pad(x, 3, pad)
            padding = (self.padding[0], 0, self.padding[2])
        conv = functools.partial(_CONV_FNS[x.dim()], stride=self.stride, padding=padding,
                                 dilation=self.dilation)
        if tp is None:
            return conv(x, w, b, groups=self.groups)
        y = tp_grouped_conv(conv, tp_copy(x, tp), w, self.groups, tp)
        return all_gather_tp(y, 1, tp) + b.reshape((1, -1) + (1,) * (y.dim() - 2))


def tp_grouped_conv(conv, x: torch.Tensor, w: torch.Tensor, groups: int,
                    tp: TpAxis) -> torch.Tensor:
    """``conv`` (no bias) of this rank's tp slice ``w`` of a conv's output
    channels: each output channel reads only its group's input channels,
    so a grouped conv's slice runs group by group, each group's part of
    the slice on that group's inputs."""
    if groups == 1:
        return conv(x, w, groups=1)
    per = w.shape[0] * tp.size // groups  # output channels a group
    ci = x.shape[1] // groups  # input channels a group
    lo, hi = tp.rank * w.shape[0], (tp.rank + 1) * w.shape[0]
    g0, g1 = lo // per, (hi - 1) // per + 1
    return torch.cat([conv(x.narrow(1, g * ci, ci),
                           w[max(lo, g * per) - lo:min(hi, (g + 1) * per) - lo], groups=1)
                      for g in range(g0, g1)], 1)


class Conv1d(_ComputeDtype, nn.Conv1d):
    pass


class Conv2d(_ComputeDtype, nn.Conv2d):
    pass


class Conv3d(_ComputeDtype, nn.Conv3d):
    pass


_CONVS = {1: Conv1d, 2: Conv2d, 3: Conv3d}
_CONV_FNS = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}  # by the input's rank


def conv_nd(in_ch: int, out_ch: int, kernel: int = 3, *, dims: int = 3, stride=1,
            groups: int = 1, dtype=None, zero_init: bool = False):
    """``dims``-D convolution (1, 2 or 3) with torch-style symmetric
    padding; ``groups`` is flax's ``feature_group_count``."""
    if dims not in _CONVS:
        raise NotImplementedError(f"conv_nd: dims must be 1, 2 or 3 (torch has no "
                                  f"{dims}-D convolution), got {dims}")
    return _CONVS[dims](in_ch, out_ch, kernel, stride=stride, groups=groups, dtype=dtype,
                        zero_init=zero_init)


_POOLS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_CHANNELS_LAST = {4: torch.channels_last, 5: torch.channels_last_3d}


def avg_pool_nd(x: torch.Tensor, window) -> torch.Tensor:
    """Average pooling over the spatial dims (one ``window`` entry each),
    accumulated in float32 and rounded once to ``x``'s dtype, in ``x``'s
    memory format."""
    window = tuple(window)
    cl = _CHANNELS_LAST.get(x.dim())
    fmt = cl if cl is not None and x.is_contiguous(memory_format=cl) else torch.contiguous_format
    return _POOLS[len(window)](x.float(), window).to(x.dtype, memory_format=fmt)
