"""WDM-style wavelet U-Net (port of ``fast_cwdm_tpu/models/wunet.py``).

The model's down/upsampling IS the Haar DWT/IDWT (``use_freq=True``):
downsampling emits ``(LLL/3, highs)``, the 7 high subbands kept as the
skip; upsampling reconstructs with ``idwt(3·x, highs)``; an input pyramid
(``WaveletDownsample``) adds a DWT'd projection of the raw input at every
level (``progressive_input="residual"``).

Tensors are logical NCDHW, as in ``models/unet.py``; the high subbands
travel in the JAX package's channels-last band layout ``(B, X, Y, Z, 7,
C)``. The multi-channel transforms are the plain torch ``dwt3``/``idwt3``:
the JAX package runs them as XLA, not as its single-channel Pallas
kernels.

Parameter names follow the reference torch layout (``training/bridge.py::
wunet_layout``). The reference decoder re-registers the previous ResBlock
(and attention) in every upsample block; here those entries are the same
module objects, so the state_dict carries both keys of each shared tensor,
as the reference's does, and ``ref_compat`` runs them a second time, as
the reference's forward does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fast_cwdm_tpu_torch.models.nn import GroupNorm32, avg_pool_nd, conv_nd
from fast_cwdm_tpu_torch.models.unet import (
    AttentionBlock,
    Downsample,
    Embedding,
    Linear,
    Upsample,
    _channels_first,
    _channels_last,
    _down_window,
    embedding,
    nearest_upsample,
    refuse_sp,
)
from fast_cwdm_tpu_torch.ops import wavelet as wv


def wav_down(x: torch.Tensor, wavelet: str = "haar") -> tuple[torch.Tensor, torch.Tensor]:
    """DWT downsample of NCDHW ``x`` → ``(LLL/3`` NCDHW, ``highs``
    (B, X/2, Y/2, Z/2, 7, C)``)``."""
    bands = wv.dwt3(_channels_last(x), wavelet)
    return _channels_first(bands[..., 0, :] / 3.0), bands[..., 1:, :]


def wav_up(x: torch.Tensor, highs: torch.Tensor, wavelet: str = "haar") -> torch.Tensor:
    """IDWT upsample of NCDHW ``x`` (the LLL/3 band) with ``highs`` →
    full-resolution NCDHW features."""
    bands = torch.cat([(3.0 * _channels_last(x))[..., None, :], highs], dim=-2)
    return _channels_first(wv.idwt3(bands, wavelet))


class SkipConv(nn.Module):
    """Grouped 3³ conv over the 7 high-subband skips (JAX `wunet.py:55`):
    bands concatenated on channels, /3, conv with 7 groups (``conv``), ×3."""

    def __init__(self, channels: int, out_channels: int, dims: int = 3, dtype=None):
        super().__init__()
        self.out_channels = out_channels
        self.conv = conv_nd(7 * channels, 7 * out_channels, 3, dims=dims, groups=7, dtype=dtype)

    def forward(self, highs: torch.Tensor) -> torch.Tensor:
        *lead, seven, c = highs.shape
        flat = highs.reshape(*lead, seven * c) / 3.0
        out = _channels_last(self.conv(_channels_first(flat))) * 3.0
        return out.reshape(*lead, seven, self.out_channels)


class WaveletDownsample(nn.Module):
    """Input-pyramid block (JAX `wunet.py:80`): DWT all 8 subbands,
    concatenated on channels band-major, /3, 3³ conv (``conv``) to
    ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, wavelet: str = "haar", dtype=None):
        super().__init__()
        self.wavelet = wavelet
        self.conv = conv_nd(8 * in_channels, out_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = wv.dwt3_flat(_channels_last(x), self.wavelet) / 3.0
        return self.conv(_channels_first(flat))


class WavResBlock(nn.Module):
    """ResBlock with frequency-aware up/down (JAX `wunet.py:96-183`).

    Unlike the UNet's ResBlock, ``in_layers`` run entirely before the
    resample. ``down``: DWT both branches; the hidden branch's 7 high
    subbands are the emitted skip. ``up``: IDWT both branches with the
    level's stored subbands. ``forward(x, emb, highs=None)`` returns
    ``(h, highs out or None)``.
    """

    def __init__(self, channels, emb_channels, dropout=0.0, out_channels=None,
                 use_scale_shift_norm=False, dims=3, up=False, down=False, num_groups=32,
                 resample_2d=True, use_freq=True, wavelet="haar", dtype=None):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.dims, self.resample_2d = dims, resample_2d
        self.use_freq, self.wavelet = use_freq, wavelet
        self.use_scale_shift_norm = use_scale_shift_norm
        # set by WavUNetModel (use_checkpoint): recompute in the backward
        self.remat = False
        self.in_layers = nn.Sequential(
            GroupNorm32(num_groups, channels), nn.SiLU(),
            conv_nd(channels, out_ch, 3, dims=dims, dtype=dtype),
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch, dtype),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(num_groups, out_ch), nn.SiLU(), nn.Dropout(dropout),
            conv_nd(out_ch, out_ch, 3, dims=dims, dtype=dtype, zero_init=True),
        )
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else conv_nd(channels, out_ch, 1, dims=dims, dtype=dtype))

    def forward(self, x, emb, highs=None):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, emb, highs, use_reentrant=False)
        return self._forward(x, emb, highs)

    def _forward(self, x, emb, highs):
        norm_in, _, conv_in = self.in_layers
        h = conv_in(F.silu(norm_in(x)))
        out_skip = None
        if self.down:
            if self.use_freq:
                h, out_skip = wav_down(h, self.wavelet)
                x, _ = wav_down(x, self.wavelet)
            else:
                window = _down_window(self.dims, self.resample_2d)
                h, x = avg_pool_nd(h, window), avg_pool_nd(x, window)
        elif self.up:
            if self.use_freq:
                if highs is None:
                    raise ValueError("a frequency upsample needs the level's skip subbands")
                h, x = wav_up(h, highs, self.wavelet), wav_up(x, highs, self.wavelet)
            else:
                h = nearest_upsample(h, self.dims, self.resample_2d)
                x = nearest_upsample(x, self.dims, self.resample_2d)

        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)
        emb_out = emb_out[(...,) + (None,) * (h.dim() - 2)]
        norm_out, _, dropout, conv_out = self.out_layers
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = norm_out(h) * (1 + scale) + shift
        else:
            h = norm_out(h + emb_out)
        h = conv_out(dropout(F.silu(h)))
        return self.skip_connection(x) + h, out_skip


class WavUNetModel(nn.Module):
    """The wavelet U-Net (JAX `wunet.py:186-444`).

    Encoder: per level, ResBlocks (+ attention), a frequency-downsample
    ResBlock (every level, the last included, so each spatial size must
    halve evenly once per level) and the input pyramid's residual.
    Bottleneck ResBlock[, attention], ResBlock. Decoder: per level,
    ResBlocks (+ attention) then a frequency-upsample ResBlock fed the
    level's stored subbands; ``num_res_blocks`` tail ResBlocks
    (``out_res``); a GN→SiLU→3³ conv head that is NOT zero-initialised.

    ``ref_compat`` reproduces the reference decoder: each upsample block
    first re-runs the preceding ResBlock (+ attention) with the same
    parameters, which runs only where that block keeps its width.
    ``num_classes`` adds a class embedding, as ``UNetModel`` (a documented
    deviation of the JAX package: the reference's flag is dead).
    ``use_checkpoint`` recomputes every ``WavResBlock`` in the backward
    pass. ``additive_skips`` raises ``ValueError``: the skips are the
    subbands the upsample needs.
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
        resblock_updown: bool = True,
        use_new_attention_order: bool = False,
        num_groups: int = 32,
        bottleneck_attention: bool = True,
        resample_2d: bool = True,
        additive_skips: bool = False,
        use_freq: bool = True,
        progressive_input: str = "residual",
        wavelet: str = "haar",
        ref_compat: bool = False,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if additive_skips:
            # the reference's WavUNet additive branch adds a tensor to a
            # tuple of subbands (dead code); the skips here are the
            # subbands the upsample needs (JAX `wunet.py:267-282`)
            raise ValueError(
                "WavUNetModel does not support additive_skips (broken dead code in the "
                "reference, see wunet.py:752-775); use UNetModel(additive_skips=True) or the "
                "frequency skips"
            )
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.num_res_blocks = num_res_blocks
        self.resblock_updown = resblock_updown
        self.conv_resample = conv_resample
        self.bottleneck_attention = bottleneck_attention
        self.use_freq = use_freq
        self.progressive_input = progressive_input
        self.wavelet = wavelet
        self.ref_compat = ref_compat
        self.dims = dims
        self.dtype = dtype
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        nrb = num_res_blocks

        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            Linear(model_channels, ted), nn.SiLU(), Linear(ted, ted)
        )
        if num_classes is not None:
            self.label_emb = Embedding(num_classes, ted)

        def resblock(ch_in, ch_out=None, **kw):
            block = WavResBlock(ch_in, ted, dropout, ch_out,
                                use_scale_shift_norm=use_scale_shift_norm, dims=dims,
                                num_groups=num_groups, resample_2d=resample_2d,
                                use_freq=use_freq, wavelet=wavelet, dtype=dtype, **kw)
            block.remat = use_checkpoint
            return block

        def attention(ch, heads):
            return AttentionBlock(ch, heads, num_head_channels, use_new_attention_order,
                                  num_groups, dtype)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([conv_nd(in_channels, model_channels, 3, dims=dims, dtype=dtype)])]
        )
        ch, ds, pyramid_ch = model_channels, 1, in_channels
        skip_chans = []  # channels of each level's stored subbands
        for mult in self.channel_mult:
            for _ in range(nrb):
                layers = nn.ModuleList([resblock(ch, mult * model_channels)])
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(attention(ch, num_heads))
                self.input_blocks.append(layers)
            # the frequency downsample (parameterless as a bare DWT)
            if resblock_updown:
                down = [resblock(ch, ch, down=True)]
            elif use_freq:
                down = []
            else:
                down = [Downsample(ch, conv_resample, ch, resample_2d, dtype, dims)]
            self.input_blocks.append(nn.ModuleList(down))
            skip_chans.append(ch)
            # the input pyramid's block (empty when not "residual": the
            # index still advances, as in the reference)
            pyramid = []
            if progressive_input == "residual":
                pyramid = [WaveletDownsample(pyramid_ch, ch, wavelet, dtype)]
                pyramid_ch = ch
            self.input_blocks.append(nn.ModuleList(pyramid))
            ds *= 2

        self.middle_block = nn.ModuleList(
            [resblock(ch)]
            + ([attention(ch, num_heads)] if bottleneck_attention else [])
            + [resblock(ch)]
        )

        self.output_blocks = nn.ModuleList()
        for mult in self.channel_mult[::-1]:
            for i in range(nrb + 1):
                if i != nrb:
                    mid_ch = model_channels * mult
                    layers = nn.ModuleList([resblock(ch, mid_ch)])
                    if ds in self.attention_resolutions:
                        layers.append(attention(mid_ch, heads_up))
                    ch = mid_ch
                    self.output_blocks.append(layers)
                    continue
                # the upsample block; with resblock_updown it holds the
                # previous block's modules too (the reference layout)
                if resblock_updown:
                    prev = list(self.output_blocks[-1]) if nrb else []
                    up = prev + [resblock(ch, ch, up=True)]
                elif use_freq:
                    up = [SkipConv(skip_chans[-1], ch, dims, dtype)] if conv_resample else []
                else:
                    up = [Upsample(ch, conv_resample, ch, resample_2d, dtype, dims)]
                self.output_blocks.append(nn.ModuleList(up))
                skip_chans.pop()
                ds //= 2

        self.out_res = nn.ModuleList([nn.ModuleList([resblock(ch, ch)]) for _ in range(nrb)])
        self.out = nn.Sequential(
            GroupNorm32(num_groups, ch), nn.SiLU(),
            conv_nd(ch, out_channels, 3, dims=dims),
        )

    @staticmethod
    def _run(layers, h, emb):
        """A ResBlock (its subband output dropped) and its attention."""
        res, *attn = layers
        h, _ = res(h, emb)
        for a in attn:
            h = a(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        refuse_sp(self)
        emb = embedding(self, timesteps, y).to(self.dtype or x.dtype)
        nrb = self.num_res_blocks

        h = self.input_blocks[0][0](x)
        pyramid = x
        hs: list = []  # per encoder block: its stored subbands, or None
        blocks = iter(self.input_blocks[1:])
        for _ in self.channel_mult:
            for _ in range(nrb):
                h = self._run(next(blocks), h, emb)
                hs.append(None)
            down = next(blocks)
            if self.resblock_updown:
                h, skip7 = down[0](h, emb)
            elif self.use_freq:
                h, skip7 = wav_down(h, self.wavelet)
            else:
                h, skip7 = down[0](h), None
            hs.append(skip7)
            pyr = next(blocks)
            if self.progressive_input == "residual":
                pyramid = pyr[0](pyramid) + h
                h = pyramid

        h, _ = self.middle_block[0](h, emb)
        for layer in self.middle_block[1:-1]:
            h = layer(h)
        h, _ = self.middle_block[-1](h, emb)

        skip7 = None
        bidx = 0
        for _ in self.channel_mult:
            for i in range(nrb + 1):
                new_hs = hs.pop()
                if new_hs is not None:
                    skip7 = new_hs
                layers = self.output_blocks[bidx]
                if i != nrb:
                    h = self._run(layers, h, emb)
                else:
                    if self.ref_compat and nrb:
                        # the reference's double run: the previous block's
                        # modules once more, with the same parameters
                        h = self._run(self.output_blocks[bidx - 1], h, emb)
                    if self.resblock_updown:
                        h, _ = layers[-1](h, emb, skip7)
                    elif self.use_freq:
                        if self.conv_resample:
                            skip7 = layers[0](skip7)
                        h = wav_up(h, skip7, self.wavelet)
                    else:
                        h = layers[0](h)
                bidx += 1

        for (res,) in self.out_res:
            h, _ = res(h, emb)
        norm, _, conv = self.out
        return conv(F.silu(norm(h))).float()
