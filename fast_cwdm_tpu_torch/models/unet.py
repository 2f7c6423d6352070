"""3-D UNet denoiser (port of ``fast_cwdm_tpu/models/unet.py``).

Tensors are logical NCDHW (spatial axes in the JAX package's X, Y, Z
order). Callers holding channels-last ``(B, X, Y, Z, C)`` data pass
``x.permute(0, 4, 1, 2, 3)``: a free view whose memory is
``channels_last_3d``, the format cuDNN's 3-D convolutions prefer, and
every activation keeps it.

Parameter names and shapes follow the reference torch layout that the
JAX package's ``training/bridge.py::flax_to_torch`` emits
(``input_blocks.N.M``, ``in_layers.0``, ...), so reference ``.pt`` files
load with ``load_state_dict(strict=True)``.

Ported: ResBlocks (with resblock_updown, scale-shift norm, additive skips),
conv/avg-pool resampling, and the fused GN-apply+SiLU route (kernel K3,
``fuse_gn_silu``). Not yet ported, and refused with ``NotImplementedError``:
attention blocks (the production config has none), class conditioning,
gradient checkpointing, and ``fuse_conv`` (the fused conv kernel K4).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fast_cwdm_tpu_torch.models.nn import (
    Conv3d,
    GroupNorm32,
    avg_pool_nd,
    conv_nd,
    timestep_embedding,
)


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s dtype rule (see Conv3d)."""

    def __init__(self, in_f: int, out_f: int, dtype=None):
        super().__init__(in_f, out_f)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def nearest_upsample(x: torch.Tensor, resample_2d: bool) -> torch.Tensor:
    """Nearest-neighbour ×2; with ``resample_2d`` only the inner two
    spatial axes are scaled."""
    return F.interpolate(x, scale_factor=(1, 2, 2) if resample_2d else 2, mode="nearest")


def _down_window(resample_2d: bool) -> tuple[int, ...]:
    return (1, 2, 2) if resample_2d else (2, 2, 2)


class Upsample(nn.Module):
    """×2 nearest upsample + optional conv (parameter ``conv``)."""

    def __init__(self, channels, use_conv, out_channels=None, resample_2d=True, dtype=None):
        super().__init__()
        self.resample_2d = resample_2d
        if use_conv:
            self.conv = conv_nd(channels, out_channels or channels, 3, dtype=dtype)

    def forward(self, x, emb=None):
        x = nearest_upsample(x, self.resample_2d)
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample(nn.Module):
    """Strided conv (parameter ``op``) or average-pool ×2 downsample."""

    def __init__(self, channels, use_conv, out_channels=None, resample_2d=True, dtype=None):
        super().__init__()
        self.window = _down_window(resample_2d)
        if use_conv:
            self.op = conv_nd(channels, out_channels or channels, 3, stride=self.window, dtype=dtype)
        elif (out_channels or channels) != channels:
            raise ValueError("average-pool downsample cannot change the channel count")

    def forward(self, x, emb=None):
        return self.op(x) if hasattr(self, "op") else avg_pool_nd(x, self.window)


def FusableConv3d(in_ch: int, out_ch: int, *, dtype=None, zero_init: bool = False) -> Conv3d:
    """The ResBlock 3³ conv: input and fp32 params cast to ``dtype`` (or
    the input's dtype when None, `unet.py:190-193`)."""
    return Conv3d(in_ch, out_ch, 3, dtype=dtype, zero_init=zero_init, follow_input=True)


class ResBlock(nn.Module):
    """Residual block with timestep conditioning.

    GN→SiLU→conv, + temb (or FiLM scale-shift), GN→SiLU→dropout→zero conv,
    skip (identity, or 1×1/3×3 conv when channels change). ``up``/``down``
    resample both the hidden and the skip branch between the first
    norm-act and its conv; the skip branch resamples ``x``, not ``h``.
    """

    def __init__(self, channels, emb_channels, dropout=0.0, out_channels=None,
                 use_conv=False, use_scale_shift_norm=False, up=False, down=False,
                 num_groups=32, resample_2d=True, fuse_conv=False,
                 fuse_gn_silu=False, dtype=None):
        super().__init__()
        if fuse_conv:
            raise NotImplementedError(
                "fuse_conv routes ResBlock convs through the fused conv kernel "
                "K4 (fast_cwdm_tpu/ops/conv3d_pallas.py), not ported yet"
            )
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.resample_2d = resample_2d
        self.use_scale_shift_norm = use_scale_shift_norm
        self.fuse_gn_silu = fuse_gn_silu
        self.in_layers = nn.Sequential(
            GroupNorm32(num_groups, channels),
            nn.SiLU(),
            FusableConv3d(channels, out_ch, dtype=dtype),
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch, dtype),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(num_groups, out_ch),
            nn.SiLU(),
            nn.Dropout(dropout),
            FusableConv3d(out_ch, out_ch, dtype=dtype, zero_init=True),
        )
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = conv_nd(channels, out_ch, 3 if use_conv else 1, dtype=dtype)

    def _norm_act(self, norm: GroupNorm32, h: torch.Tensor) -> torch.Tensor:
        return norm(h, act="silu") if self.fuse_gn_silu else F.silu(norm(h))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm_in, _, conv_in = self.in_layers
        h = self._norm_act(norm_in, x)
        if self.up:
            h = nearest_upsample(h, self.resample_2d)
            x = nearest_upsample(x, self.resample_2d)
        elif self.down:
            h = avg_pool_nd(h, _down_window(self.resample_2d))
            x = avg_pool_nd(x, _down_window(self.resample_2d))
        h = conv_in(h)

        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)
        emb_out = emb_out[(...,) + (None,) * (h.dim() - 2)]
        norm_out, _, dropout, conv_out = self.out_layers
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(norm_out(h) * (1 + scale) + shift)
        else:
            h = self._norm_act(norm_out, h + emb_out)
        h = conv_out(dropout(h))
        return self.skip_connection(x) + h


class UNetModel(nn.Module):
    """The production denoiser: encoder ResBlocks + downsampling, two
    bottleneck ResBlocks, decoder with concatenated (or averaged additive)
    skips and upsampling, GN→SiLU→zero conv head; fp32 output.

    ``forward(x, timesteps)`` takes logical NCDHW ``x`` and returns NCDHW.
    ``dtype`` (None, torch.float32 or torch.bfloat16) is the compute dtype;
    params stay fp32 and GroupNorm statistics are fp32 regardless.
    """

    def __init__(
        self,
        image_size: int,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        dims: int = 3,
        num_classes: int | None = None,
        use_checkpoint: bool = False,
        num_heads: int = 1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        num_groups: int = 32,
        bottleneck_attention: bool = True,
        resample_2d: bool = True,
        additive_skips: bool = False,
        fuse_conv: bool = False,
        fuse_gn_silu: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if dims != 3:
            raise NotImplementedError("the port implements dims=3 only")
        if attention_resolutions or bottleneck_attention:
            raise NotImplementedError(
                "AttentionBlock is not ported yet (the production config has "
                "no attention: attention_resolutions='' and "
                "bottleneck_attention=False)"
            )
        if num_classes is not None:
            raise NotImplementedError("class conditioning is not ported yet")
        if use_checkpoint:
            raise NotImplementedError("gradient checkpointing comes with the training port")
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.resblock_updown = resblock_updown
        self.conv_resample = conv_resample
        self.additive_skips = additive_skips
        self.fuse_gn_silu = fuse_gn_silu
        self.dtype = dtype

        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            Linear(model_channels, ted), nn.SiLU(), Linear(ted, ted)
        )

        def resblock(ch_in, ch_out, **kw):
            return ResBlock(
                ch_in, ted, dropout, ch_out,
                use_scale_shift_norm=use_scale_shift_norm,
                num_groups=num_groups, resample_2d=resample_2d,
                fuse_conv=fuse_conv, fuse_gn_silu=fuse_gn_silu, dtype=dtype, **kw,
            )

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([conv_nd(in_channels, model_channels, 3, dtype=dtype)])]
        )
        skip_chans = [model_channels]
        ch = model_channels
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                self.input_blocks.append(nn.ModuleList([resblock(ch, mult * model_channels)]))
                ch = mult * model_channels
                skip_chans.append(ch)
            if level != len(self.channel_mult) - 1:
                down = (
                    resblock(ch, ch, down=True)
                    if resblock_updown
                    else Downsample(ch, conv_resample, ch, resample_2d, dtype)
                )
                self.input_blocks.append(nn.ModuleList([down]))
                skip_chans.append(ch)

        self.middle_block = nn.ModuleList([resblock(ch, ch), resblock(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(self.channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                ich = skip_chans.pop()
                if additive_skips:
                    mid_ch = skip_chans[-1] if skip_chans else model_channels
                    in_ch = ch
                else:
                    mid_ch = model_channels * mult
                    in_ch = ch + ich
                layers = nn.ModuleList([resblock(in_ch, mid_ch)])
                ch = mid_ch
                if level and i == num_res_blocks:
                    layers.append(
                        resblock(ch, ch, up=True)
                        if resblock_updown
                        else Upsample(ch, conv_resample, ch, resample_2d, dtype)
                    )
                self.output_blocks.append(layers)

        self.out = nn.Sequential(
            GroupNorm32(num_groups, model_channels),
            nn.SiLU(),
            conv_nd(model_channels, out_channels, 3, zero_init=True),
        )

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        emb = emb.to(self.dtype or x.dtype)

        h = self.input_blocks[0][0](x)
        hs = [h]
        for (block,) in self.input_blocks[1:]:
            h = block(h, emb)
            hs.append(h)
        for block in self.middle_block:
            h = block(h, emb)
        for layers in self.output_blocks:
            skip = hs.pop()
            h = (h + skip) / 2.0 if self.additive_skips else torch.cat([h, skip], dim=1)
            for block in layers:
                h = block(h, emb)

        norm, _, conv = self.out
        h = norm(h, act="silu") if self.fuse_gn_silu else F.silu(norm(h))
        return conv(h).float()
