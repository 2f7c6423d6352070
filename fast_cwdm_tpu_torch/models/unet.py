"""UNet model family (port of ``fast_cwdm_tpu/models/unet.py``): the
denoiser ``UNetModel``, ``SuperResModel`` and the classifier
``EncoderUNetModel``, with their blocks.

Tensors are logical N, C, spatial (NCDHW for ``dims=3``, spatial axes in
the JAX package's X, Y, Z order; NCHW for ``dims=2``; NCL for ``dims=1``).
Callers holding channels-last ``(B, X, Y, Z, C)`` data pass
``x.permute(0, 4, 1, 2, 3)``: a free view whose memory is
``channels_last_3d``, the format cuDNN's 3-D convolutions prefer, and
every activation keeps it.

Parameter names and shapes follow the reference torch layout that the
JAX package's ``training/bridge.py::flax_to_torch`` emits
(``input_blocks.N.M``, ``in_layers.0``, ...), so reference ``.pt`` files
load with ``load_state_dict(strict=True)``.

Ported: ResBlocks (with resblock_updown, scale-shift norm, additive skips),
conv/avg-pool resampling, ``AttentionBlock`` (both head orders,
``num_head_channels``), class conditioning (``num_classes``), ``dims`` 1,
2 and 3, the wavelet-gated resampling blocks, the fused GN-apply+SiLU route
(kernel K3 and its VJP, ``fuse_gn_silu``), the fused GN→SiLU→conv route
(kernel K4b, ``fuse_conv``, 3-D only, inference only, as in the JAX
package) and gradient checkpointing (``use_checkpoint`` with
``remat_max_ds``). Dropout follows ``model.train()``/``model.eval()`` (the
JAX package's ``train=``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fast_cwdm_tpu_torch.models.nn import (
    Conv3d,
    GroupNorm32,
    avg_pool_nd,
    conv_nd,
    timestep_embedding,
)
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.ops.wavelet import dtype_scalar
from fast_cwdm_tpu_torch.ops.conv3d_cuda import WG_BN, conv3d_fused, group_stats, pack_weights
from fast_cwdm_tpu_torch.parallel.mesh import (
    all_gather_sp,
    all_gather_tp,
    bind_axes,
    current_sp,
    halo_exchange,
    local_slab,
    sp_active,
    tp_copy,
    tp_shard_axis,
    tp_slice,
)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """``F.linear`` of a weight of ``n_out`` output rows, or of a tp slice
    of them, gathered over the tp axis with the replicated bias added
    after and the input's gradient summed over it (as ``Conv3d``)."""
    tp = tp_shard_axis(w.shape[0], n_out)
    if tp is None:
        return F.linear(x, w, b)
    return all_gather_tp(F.linear(tp_copy(x, tp), w), -1, tp) + b


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s dtype rule (see Conv3d); a tp
    slice of its outputs is gathered (:func:`dense`)."""

    def __init__(self, in_f: int, out_f: int, dtype=None):
        super().__init__(in_f, out_f)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return dense(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.out_features)


class Embedding(nn.Embedding):
    """``nn.Embedding``; a tp slice of its features (dim 1 of the weight,
    flax ``Embed``'s last axis) is gathered over the tp axis."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        tp = tp_shard_axis(self.weight.shape[1], self.embedding_dim)
        out = super().forward(y)
        return out if tp is None else all_gather_tp(out, -1, tp)


def nearest_upsample(x: torch.Tensor, dims: int, resample_2d: bool) -> torch.Tensor:
    """Nearest-neighbour ×2; for 3-D with ``resample_2d`` only the inner two
    spatial axes are scaled."""
    scale = (1, 2, 2) if dims == 3 and resample_2d else 2
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def _down_window(dims: int, resample_2d: bool) -> tuple[int, ...]:
    return (1, 2, 2) if dims == 3 and resample_2d else (2,) * dims


class Upsample(nn.Module):
    """×2 nearest upsample + optional conv (parameter ``conv``)."""

    def __init__(self, channels, use_conv, out_channels=None, resample_2d=True, dtype=None,
                 dims=3):
        super().__init__()
        self.dims, self.resample_2d = dims, resample_2d
        if use_conv:
            self.conv = conv_nd(channels, out_channels or channels, 3, dims=dims, dtype=dtype)

    def forward(self, x, emb=None):
        x = nearest_upsample(x, self.dims, self.resample_2d)
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample(nn.Module):
    """Strided conv (parameter ``op``) or average-pool ×2 downsample."""

    def __init__(self, channels, use_conv, out_channels=None, resample_2d=True, dtype=None,
                 dims=3):
        super().__init__()
        self.window = _down_window(dims, resample_2d)
        if use_conv:
            self.op = conv_nd(channels, out_channels or channels, 3, dims=dims,
                              stride=self.window, dtype=dtype)
        elif (out_channels or channels) != channels:
            raise ValueError("average-pool downsample cannot change the channel count")

    def forward(self, x, emb=None):
        return self.op(x) if hasattr(self, "op") else avg_pool_nd(x, self.window)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """NCDHW → the JAX package's (B, X, Y, Z, C) view."""
    return x.permute(0, 2, 3, 4, 1)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) → the NCDHW view."""
    return x.permute(0, 4, 1, 2, 3)


class _WaveletGate(nn.Module):
    """sigmoid(MLP(global average pool ⊕ temb)) → one gate per subband
    (parameters ``fnn.0`` and ``fnn.2``, the JAX package's ``fnn_0`` and
    ``fnn_2``)."""

    def __init__(self, channels: int, temb_dim: int, dtype=None):
        super().__init__()
        self.fnn = nn.Sequential(Linear(channels + temb_dim, 128, dtype), nn.SiLU(),
                                 Linear(128, 8, dtype))

    def gates(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        """(B, 1, 1, 1, 8, 1) gates for (B, X, Y, Z, 8, C) subbands."""
        pooled = x.mean(dim=tuple(range(2, x.dim())))  # (B, C)
        g = self.fnn[0](torch.cat([pooled, temb], dim=-1))
        g = self.fnn[2](F.silu(g))
        return torch.sigmoid(g).reshape(g.shape[0], 1, 1, 1, 8, 1)


class WaveletGatingDownsample(_WaveletGate):
    """Wavelet-gated downsample (JAX `unet.py:112-137`): DWT the features,
    gate each of the 8 subbands, sum the gated subbands. 3-D."""

    def __init__(self, channels: int, temb_dim: int, wavelet: str = "haar", dtype=None):
        super().__init__(channels, temb_dim, dtype)
        self.wavelet = wavelet

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        bands = wv.dwt3(_channels_last(x), self.wavelet)  # (B, X/2, Y/2, Z/2, 8, C)
        return _channels_first((bands * self.gates(x, temb)).sum(dim=-2))


class WaveletGatingUpsample(_WaveletGate):
    """Wavelet-gated upsample (JAX `unet.py:140-162`): 1×1×1 conv
    (``conv_exp``) into 8 subbands of ``channels``, gate them, IDWT. 3-D."""

    def __init__(self, channels: int, temb_dim: int, wavelet: str = "haar", dtype=None):
        super().__init__(channels, temb_dim, dtype)
        self.channels, self.wavelet = channels, wavelet
        self.conv_exp = conv_nd(channels, channels * 8, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        expanded = _channels_last(self.conv_exp(x))  # (B, X, Y, Z, 8C)
        bands = expanded.reshape(*expanded.shape[:-1], 8, self.channels)
        return _channels_first(wv.idwt3(bands * self.gates(x, temb), self.wavelet))


class FusableConv3d(Conv3d):
    """The ResBlock 3³ conv: input and fp32 params cast to ``dtype`` (or
    the input's dtype when None, `unet.py:190-193`). With ``gn`` (mean,
    inv, scale, bias) the GN-apply+SiLU prologue runs inside the fused conv
    (K4b, ``conv3d_fused(block_x=2)``), for every C and X: the JAX
    package's fallback to an XLA conv (C > 128, X odd) is a TPU VMEM and
    tiling limit, and computes the same function. The conv is handed
    :meth:`packed_weight`, which it calls only where the card's route is
    the wgmma (either width, or fp32's 3×TF32), or the split-K kernel: the
    weight is repacked once as the route reads it (its pack's dtype and
    width) and kept until the parameter changes (its version, storage,
    shape or device).
    Under the tp axis the weight is this rank's slice of the output
    channels (``shard_params``): K4b computes them with the bias's slice
    and the output is gathered over the tp group."""

    def __init__(self, in_ch: int, out_ch: int, *, dtype=None, zero_init: bool = False):
        super().__init__(in_ch, out_ch, 3, dtype=dtype, zero_init=zero_init, follow_input=True)
        self._packed = {}  # (dtype, width) → (key, the packed weight)

    def packed_weight(self, bn: int = WG_BN, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The DHWIO weight packed for the routes that read it at
        output-channel width ``bn`` in ``dtype``: ``pack_wgmma_weights`` in
        bf16 (wgmma, wgmma_n32, splitk), ``pack_tf32_weights`` in fp32
        (wgmma_tf32). Kept per (dtype, width), so a bf16 and an fp32 pack of
        one width never stand in for each other, and rebuilt only when the
        parameter was written (``load_state_dict``, an optimizer step) or
        moved."""
        wt = self.weight
        key = (wt._version, wt.data_ptr(), tuple(wt.shape), wt.device)
        slot = (dtype, bn)
        if self._packed.get(slot, (None,))[0] != key:
            with torch.no_grad():
                self._packed[slot] = (key, pack_weights(wt.permute(2, 3, 4, 1, 0), dtype, bn))
        return self._packed[slot][1]

    def forward(self, x: torch.Tensor, gn=None) -> torch.Tensor:
        if gn is None:
            return super().forward(x)
        dt = self.compute_dtype or x.dtype
        cl = torch.channels_last_3d
        xx = x.to(dt, memory_format=cl)
        # under sp: the neighbours' raw planes on the slab's interior sides;
        # the kernel applies the prologue to them with the volume's
        # statistics and zero-pads only the volume's edges (the ends of the
        # extended slab there); the rows computed at the halo planes go
        ext, lo, hi = halo_exchange(xx, 3, 1)
        if lo or hi:
            xx = ext.contiguous(memory_format=cl)
        # OIDHW → DHWIO; the conv casts it to dt (the wgmma and splitk
        # routes read the packed copy instead)
        w = self.weight.permute(2, 3, 4, 1, 0)
        tp = tp_shard_axis(self.weight.shape[0], self.out_channels)
        bias = self.bias if tp is None else tp_slice(self.bias, tp)
        out = conv3d_fused(xx, w, bias.to(dt), gn=gn, block_x=2,
                           w_packed=self.packed_weight)
        if lo or hi:
            out = out[:, :, :, lo:out.shape[3] - hi].contiguous(memory_format=cl)
        return out if tp is None else all_gather_tp(out, 1, tp)


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
                 fuse_gn_silu=False, dtype=None, dims=3):
        super().__init__()
        out_ch = out_channels or channels
        self.up, self.down = up, down
        self.dims, self.resample_2d = dims, resample_2d
        self.use_scale_shift_norm = use_scale_shift_norm
        self.fuse_gn_silu = fuse_gn_silu
        # both GN→SiLU→conv chains through K4b (`unet.py:257-264`); the
        # configuration decides, as the JAX package's `dims == 3` test
        self.fuse = (fuse_conv and dims == 3 and not (up or down)
                     and not use_scale_shift_norm and dropout == 0)
        self.num_groups = num_groups
        # set by UNetModel: recompute this block's activations in the
        # backward pass instead of keeping them (use_checkpoint)
        self.remat = False

        def conv(ci, co, zero_init=False):
            if dims == 3:
                return FusableConv3d(ci, co, dtype=dtype, zero_init=zero_init)
            return conv_nd(ci, co, 3, dims=dims, dtype=dtype, zero_init=zero_init)

        self.in_layers = nn.Sequential(
            GroupNorm32(num_groups, channels),
            nn.SiLU(),
            conv(channels, out_ch),
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch, dtype),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(num_groups, out_ch),
            nn.SiLU(),
            nn.Dropout(dropout),
            conv(out_ch, out_ch, zero_init=True),
        )
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = conv_nd(channels, out_ch, 3 if use_conv else 1, dims=dims,
                                           dtype=dtype)

    def _norm_act(self, norm: GroupNorm32, h: torch.Tensor) -> torch.Tensor:
        return norm(h, act="silu") if self.fuse_gn_silu else F.silu(norm(h))

    def _forward_fused(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm_in, _, conv_in = self.in_layers
        norm_out, _, _, conv_out = self.out_layers
        mean, inv = group_stats(x, self.num_groups)
        h = conv_in(x, gn=(mean, inv, norm_in.weight, norm_in.bias))
        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)
        h2 = h + emb_out[(...,) + (None,) * (h.dim() - 2)]
        mean2, inv2 = group_stats(h2, self.num_groups)
        h = conv_out(h2, gn=(mean2, inv2, norm_out.weight, norm_out.bias))
        return self.skip_connection(x) + h

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            # the recomputation runs in the backward pass: under the sp and
            # tp axes of this call, so that it issues the block's
            # collectives again
            return checkpoint(bind_axes(self._forward), x, emb, use_reentrant=False)
        return self._forward(x, emb)

    def _forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.fuse:
            return self._forward_fused(x, emb)
        norm_in, _, conv_in = self.in_layers
        h = self._norm_act(norm_in, x)
        if self.up:
            h = nearest_upsample(h, self.dims, self.resample_2d)
            x = nearest_upsample(x, self.dims, self.resample_2d)
        elif self.down:
            h = avg_pool_nd(h, _down_window(self.dims, self.resample_2d))
            x = avg_pool_nd(x, _down_window(self.dims, self.resample_2d))
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


class AttentionBlock(nn.Module):
    """Self-attention over the flattened spatial positions (JAX
    `unet.py:345-400`).

    GroupNorm (fp32 statistics), then ``qkv`` and ``proj_out``: the
    reference's 1×1 ``Conv1d`` parameters ((3C, C, 1) and (C, C, 1),
    ``proj_out`` zero-initialised) applied as dense layers over the channel
    axis, as the JAX package's ``nn.Dense``. ``use_new_attention_order``
    reads qkv as ``[q | k | v]`` (qkv-major); the legacy order is head-major
    ``[h0: q k v | h1: q k v | ...]``. q and k are each scaled by 1/√√ch,
    the logits' softmax is taken in fp32 and cast back, in plain einsums in
    the JAX package's order. Not ``F.scaled_dot_product_attention``: it
    scales once and takes the softmax in the input dtype.

    The attention matrix is built whole: (heads, T, T) per sample, T the
    number of positions.
    """

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 use_new_attention_order: bool = False, num_groups: int = 32, dtype=None):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        elif channels % num_head_channels:
            raise ValueError(f"channels {channels} not divisible by num_head_channels "
                             f"{num_head_channels}")
        else:
            self.heads = channels // num_head_channels
        self.new_order = use_new_attention_order
        self.norm = GroupNorm32(num_groups, channels)
        self.qkv = conv_nd(channels, 3 * channels, 1, dims=1, dtype=dtype)
        self.proj_out = conv_nd(channels, channels, 1, dims=1, dtype=dtype, zero_init=True)

    @staticmethod
    def _dense(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        """A 1×1 conv's parameters as ``nn.Dense`` over the last axis of
        ``x``, with the conv's dtype rule."""
        dt = conv.compute_dtype or torch.promote_types(x.dtype, conv.weight.dtype)
        return dense(x.to(dt), conv.weight[:, :, 0].to(dt), conv.bias.to(dt), conv.out_channels)

    def forward(self, x: torch.Tensor, emb=None) -> torch.Tensor:
        refuse_sp(self)  # every position attends to every other
        b, c, *spatial = x.shape
        heads = self.heads
        ch = c // heads
        flat = x.flatten(2)  # (B, C, T)
        qkv = self._dense(self.qkv, self.norm(flat).transpose(1, 2))  # (B, T, 3C)
        if self.new_order:
            q, k, v = (t.reshape(b, -1, heads, ch) for t in qkv.chunk(3, dim=-1))
        else:
            q, k, v = qkv.reshape(b, -1, heads, 3 * ch).chunk(3, dim=-1)
        scale = dtype_scalar(1.0 / math.sqrt(math.sqrt(ch)), q.dtype)
        logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        weights = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        a = torch.einsum("bhts,bshc->bthc", weights, v).reshape(b, -1, c)
        out = flat.transpose(1, 2) + self._dense(self.proj_out, a)  # (B, T, C)
        return out.transpose(1, 2).reshape(b, c, *spatial)


def refuse_sp(module: nn.Module) -> None:
    """A module the sp axis does not shard raises under an active one."""
    if current_sp() is not None:
        raise NotImplementedError(
            f"{type(module).__name__} under the sp axis: the sp axis shards UNetModel's "
            "convolutions, GroupNorms and resampling, which read a slab and its halo")


def sp_stays_sharded(block: nn.Module, h: torch.Tensor) -> bool:
    """The sp axis's one rule for the UNet: a level stays sharded while
    its slab's Y (``h``'s axis 3) is even, so that a ×2 downsample is local
    (Haar and average pooling read aligned pairs; a strided conv's halo
    is one plane). Before a downsampling block whose input slab is odd,
    the activation is gathered and the deeper levels run whole."""
    down = isinstance(block, Downsample) or (isinstance(block, ResBlock) and block.down)
    return not down or h.shape[3] % 2 == 0


def embedding(model: nn.Module, timesteps: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """``model.time_embed`` of the sinusoidal timestep embedding, plus
    ``model.label_emb(y)`` where the model is class-conditional
    (``num_classes`` set); fp32. ``y`` must be given exactly then
    (``ValueError``), as the JAX package asserts."""
    num_classes = getattr(model, "num_classes", None)
    if (y is None) != (num_classes is None):
        raise ValueError("class labels y must be given exactly when the model is "
                         f"class-conditional (num_classes={num_classes})")
    t_emb = timestep_embedding(timesteps, model.model_channels)
    emb = model.time_embed[2](F.silu(model.time_embed[0](t_emb)))
    return emb if y is None else emb + model.label_emb(y)


class UNetModel(nn.Module):
    """The denoiser: encoder ResBlocks (+ attention) + downsampling, a
    bottleneck ResBlock[, attention], ResBlock, decoder with concatenated
    (or averaged additive) skips, attention and upsampling, GN→SiLU→zero
    conv head; fp32 output.

    ``forward(x, timesteps, y=None)`` takes logical N, C, spatial ``x`` and
    returns the same layout; ``y`` (class labels) is given exactly when
    ``num_classes`` is set, and its embedding is added to the timestep
    embedding. ``dtype`` (None, torch.float32 or torch.bfloat16) is the
    compute dtype; params stay fp32 and GroupNorm statistics are fp32
    regardless.

    ``use_checkpoint`` recomputes, in the backward pass, the ResBlocks at
    downsample factor ds <= ``remat_max_ds`` (0: every ResBlock) instead of
    keeping their activations (``torch.utils.checkpoint``), as the JAX
    package's selective ``nn.remat``; it acts only while autograd records.

    Under an active sp axis (``parallel.mesh.sp_active``) ``x`` is this
    rank's slab of Y (axis 3) and so is the output: the 3³ convs exchange
    halos, the GroupNorms sum over the sp group, and the levels below the
    first odd slab run whole on every rank (:func:`sp_stays_sharded`).
    Attention does not run under sp.
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
        remat_max_ds: int = 0,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.num_classes = num_classes
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.num_res_blocks = num_res_blocks
        self.resblock_updown = resblock_updown
        self.conv_resample = conv_resample
        self.bottleneck_attention = bottleneck_attention
        self.additive_skips = additive_skips
        self.fuse_gn_silu = fuse_gn_silu
        self.dims = dims
        self.dtype = dtype
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample

        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            Linear(model_channels, ted), nn.SiLU(), Linear(ted, ted)
        )
        if num_classes is not None:
            self.label_emb = Embedding(num_classes, ted)

        def resblock(ch_in, ch_out, ds, **kw):
            block = ResBlock(
                ch_in, ted, dropout, ch_out,
                use_scale_shift_norm=use_scale_shift_norm,
                num_groups=num_groups, resample_2d=resample_2d,
                fuse_conv=fuse_conv, fuse_gn_silu=fuse_gn_silu, dtype=dtype, dims=dims, **kw,
            )
            block.remat = use_checkpoint and (not remat_max_ds or ds <= remat_max_ds)
            return block

        def attention(ch, heads):
            return AttentionBlock(ch, heads, num_head_channels, use_new_attention_order,
                                  num_groups, dtype)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([conv_nd(in_channels, model_channels, 3, dims=dims, dtype=dtype)])]
        )
        skip_chans = [model_channels]
        ch = model_channels
        ds = 1
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                layers = nn.ModuleList([resblock(ch, mult * model_channels, ds)])
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(attention(ch, num_heads))
                self.input_blocks.append(layers)
                skip_chans.append(ch)
            if level != len(self.channel_mult) - 1:
                down = (
                    resblock(ch, ch, ds, down=True)
                    if resblock_updown
                    else Downsample(ch, conv_resample, ch, resample_2d, dtype, dims)
                )
                self.input_blocks.append(nn.ModuleList([down]))
                skip_chans.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList(
            [resblock(ch, ch, ds)]
            + ([attention(ch, num_heads)] if bottleneck_attention else [])
            + [resblock(ch, ch, ds)]
        )

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
                layers = nn.ModuleList([resblock(in_ch, mid_ch, ds)])
                if ds in self.attention_resolutions:
                    layers.append(attention(mid_ch, heads_up))
                ch = mid_ch
                if level and i == num_res_blocks:
                    layers.append(
                        resblock(ch, ch, ds, up=True)
                        if resblock_updown
                        else Upsample(ch, conv_resample, ch, resample_2d, dtype, dims)
                    )
                    ds //= 2
                self.output_blocks.append(layers)

        self.out = nn.Sequential(
            GroupNorm32(num_groups, model_channels),
            nn.SiLU(),
            conv_nd(model_channels, out_channels, 3, dims=dims, zero_init=True),
        )

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        axis = current_sp()
        if axis is not None and self.dims != 3:
            raise NotImplementedError("the sp axis shards the Y axis of 3-D volumes (dims=3)")
        emb = embedding(self, timesteps, y).to(self.dtype or x.dtype)

        # under sp, x is this rank's Y slab; a level stays sharded while
        # its slab can be halved (:func:`sp_stays_sharded`), the deeper
        # levels run whole on every rank of the group
        sharded = axis is not None
        h = self.input_blocks[0][0](x)
        hs = [(h, sharded)]
        for layers in self.input_blocks[1:]:
            if sharded and not sp_stays_sharded(layers[0], h):
                h, sharded = all_gather_sp(h, 3, axis), False
            with sp_active(axis if sharded else None):
                for layer in layers:
                    h = layer(h, emb)
            hs.append((h, sharded))
        with sp_active(axis if sharded else None):
            for layer in self.middle_block:
                h = layer(h, emb)
        for layers in self.output_blocks:
            skip, skip_sharded = hs.pop()
            if skip_sharded and not sharded:  # the decoder's first sharded level
                h, sharded = local_slab(h, 3, axis), True
            h = (h + skip) / 2.0 if self.additive_skips else torch.cat([h, skip], dim=1)
            with sp_active(axis if sharded else None):
                for layer in layers:
                    h = layer(h, emb)

        norm, _, conv = self.out
        h = norm(h, act="silu") if self.fuse_gn_silu else F.silu(norm(h))
        return conv(h).float()


def _linear_resize_weights(m: int, n: int, device) -> torch.Tensor:
    """(m, n) float32 weights taking an axis of m samples to n, as
    ``jax.image.resize(..., "bilinear")`` builds them
    (``jax/_src/image/scale.py::compute_weight_mat``): half-pixel sample
    positions, a triangle kernel widened by 1/scale when the axis shrinks
    (antialiasing), each output sample's weights normalised to sum 1, and
    samples outside the input zeroed."""
    f32 = torch.float32
    inv_scale = m / n  # 1 / (n / m), rounded to float32 where it is used
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=f32, device=device) + 0.5) * torch.tensor(
        inv_scale, dtype=f32) - 0.5
    dist = (sample[None, :] - torch.arange(m, dtype=f32, device=device)[:, None]).abs()
    w = torch.clamp(1.0 - dist / torch.tensor(kernel_scale, dtype=f32), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_linear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` of an (N, C, *spatial)
    tensor to the spatial ``size``, in 1, 2 or 3 dimensions: each axis
    whose length changes is contracted with its weight matrix
    (:func:`_linear_resize_weights`), one axis after another. Downscales
    antialias; upscales are plain linear interpolation with half-pixel
    centres."""
    for d, n in enumerate(size):
        axis, m = 2 + d, x.shape[2 + d]
        if m != n:
            w = _linear_resize_weights(m, n, x.device).to(x.dtype)
            x = torch.matmul(x.movedim(axis, -1), w).movedim(-1, axis)
    return x


class SuperResModel(UNetModel):
    """Super-resolution UNet (JAX `unet.py:619-635`): ``low_res`` is
    resized to ``x``'s spatial size by :func:`resize_linear` (the JAX
    package's ``jax.image.resize(..., "bilinear")``, which antialiases
    when an axis shrinks) and concatenated to ``x`` on channels.
    ``in_channels`` counts both, as the JAX package's inner UNet; the
    parameters are the UNet's own, as the reference's subclass."""

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: torch.Tensor | None = None,
                y: torch.Tensor | None = None) -> torch.Tensor:
        refuse_sp(self)  # the resize reads whole axes
        up = resize_linear(low_res, tuple(x.shape[2:]))
        return super().forward(torch.cat([x, up], dim=1), timesteps, y)


ENCODER_POOLS = ("adaptive", "spatial", "spatial_v2")


class EncoderUNetModel(nn.Module):
    """Half-UNet classifier (JAX `unet.py:638-767`), built by
    ``create_classifier``: the UNet's encoder and bottleneck (with
    attention), then a pooled head, fp32 logits (B, out_channels).

    ``pool``: "adaptive" (GN→SiLU→global mean→zero 1×1 conv; parameters
    ``out.0`` and ``out.3``, the reference's), "spatial" (the global means
    of the input conv's, every block's and the bottleneck's features,
    concatenated, → ``out.0`` Linear) or "spatial_v2" (the same features
    → ``out.0`` Linear 2048 → ``out.1`` GroupNorm → SiLU → ``out.3``
    Linear). The two spatial heads have no reference layout.
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
        num_heads: int = 1,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        pool: str = "adaptive",
        num_groups: int = 32,
        resample_2d: bool = True,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if pool not in ENCODER_POOLS:
            raise NotImplementedError(f"Unexpected {pool} pooling")
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.attention_resolutions = tuple(attention_resolutions)
        self.num_res_blocks = num_res_blocks
        self.resblock_updown = resblock_updown
        self.conv_resample = conv_resample
        self.pool = pool
        self.dims = dims

        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            Linear(model_channels, ted), nn.SiLU(), Linear(ted, ted)
        )

        def resblock(ch_in, ch_out, **kw):
            return ResBlock(ch_in, ted, dropout, ch_out, use_scale_shift_norm=use_scale_shift_norm,
                            num_groups=num_groups, resample_2d=resample_2d, dtype=dtype,
                            dims=dims, **kw)

        def attention(ch):
            return AttentionBlock(ch, num_heads, num_head_channels, use_new_attention_order,
                                  num_groups, dtype)

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([conv_nd(in_channels, model_channels, 3, dims=dims, dtype=dtype)])]
        )
        ch = model_channels
        features = ch  # channels of the spatial heads' concatenated means
        ds = 1
        for level, mult in enumerate(self.channel_mult):
            for _ in range(num_res_blocks):
                layers = nn.ModuleList([resblock(ch, mult * model_channels)])
                ch = mult * model_channels
                if ds in self.attention_resolutions:
                    layers.append(attention(ch))
                self.input_blocks.append(layers)
                features += ch
            if level != len(self.channel_mult) - 1:
                down = (resblock(ch, ch, down=True) if resblock_updown
                        else Downsample(ch, conv_resample, ch, resample_2d, dtype, dims))
                self.input_blocks.append(nn.ModuleList([down]))
                features += ch
                ds *= 2
        self.middle_block = nn.ModuleList([resblock(ch, ch), attention(ch), resblock(ch, ch)])
        features += ch

        if pool == "adaptive":
            self.out = nn.Sequential(
                GroupNorm32(num_groups, ch), nn.SiLU(),
                (nn.AdaptiveAvgPool1d, nn.AdaptiveAvgPool2d, nn.AdaptiveAvgPool3d)[dims - 1](1),
                conv_nd(ch, out_channels, 1, dims=dims, zero_init=True), nn.Flatten(),
            )
        elif pool == "spatial":
            self.out = nn.Sequential(Linear(features, out_channels))
        else:
            self.out = nn.Sequential(Linear(features, 2048), GroupNorm32(num_groups, 2048),
                                     nn.SiLU(), Linear(2048, out_channels))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        refuse_sp(self)
        emb = embedding(self, timesteps)
        spatial = tuple(range(2, x.dim()))
        keep = self.pool != "adaptive"
        h = self.input_blocks[0][0](x)
        means = [h.mean(dim=spatial)] if keep else []
        for layers in self.input_blocks[1:]:
            for layer in layers:
                h = layer(h, emb)
            if keep:
                means.append(h.mean(dim=spatial))
        for layer in self.middle_block:
            h = layer(h, emb)
        if not keep:
            return self.out(h)
        return self.out(torch.cat(means + [h.mean(dim=spatial)], dim=-1))
