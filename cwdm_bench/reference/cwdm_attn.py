"""Plain PyTorch reference of the cWDM UNet with ADM's self-attention, for
deciding ``correct`` in the cells of ``cwdm-attn-bf16``.

The trunk is ``reference/cwdm.py``'s production UNet, whose pieces it uses
(convs, dense layers, ResBlocks, the Haar transforms, the sampled schedule,
the x0 projection, the precision switch); this file adds ADM's
``AttentionBlock`` (Dhariwal & Nichol, arXiv:2105.05233, as
``openai/guided-diffusion``'s ``unet.py`` has it) after each ResBlock of the
levels that ``attention_resolutions`` names, and in the bottleneck when
``bottleneck_attention`` is set. It imports torch and numpy only: nothing
of the program, of the JAX package or of ``jax``. Everything is float32
(TF32 off).

An attention block over a feature map of T positions and C channels in
``heads`` heads of ch = C/heads channels (``num_head_channels`` sets ch,
else ``num_heads`` sets heads; the decoder takes ``num_heads_upsample``
where it is not -1):

- GroupNorm over (C, T) with the model's groups, eps 1e-5;
- qkv = dense(C → 3C) over the channels, the reference's 1×1 Conv1d
  weights; the legacy order reads it head-major ``[h0: q k v | h1: ...]``,
  ``use_new_attention_order`` as ``[q | k | v]``;
- q·s and k·s with s = 1/√√ch, softmax over the keys, ·v;
- proj_out = dense(C → C), and the residual.

The softmax is taken over blocks of ``QUERY_BLOCK`` queries, so that the
largest matrix held is (heads, QUERY_BLOCK, T). ``prec="fp8"`` rounds the
operands of the convs, the dense layers and the attention's two products
(q and k; the weights and v) to float8 e4m3: the control of a bfloat16
configuration.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cwdm_bench.reference import cwdm
from cwdm_bench.reference.cwdm import linear

QUERY_BLOCK = 2048


def attention_ds(cfg: dict) -> tuple[int, ...]:
    """The downsample factors that carry attention: ``image_size // r`` for
    each resolution r of ``attention_resolutions``."""
    res = str(cfg.get("attention_resolutions", ""))
    return tuple(int(cfg["image_size"]) // int(r) for r in res.split(",")) if res else ()


def check_config(cfg: dict) -> None:
    """The reference covers the production trunk with attention."""
    trunk = dict(cfg, attention_resolutions="", bottleneck_attention=False)
    cwdm.check_config(trunk)


def heads_of(cfg: dict, ch: int, decoder: bool = False) -> int:
    hc = int(cfg.get("num_head_channels", -1))
    if hc != -1:
        return ch // hc
    up = int(cfg.get("num_heads_upsample", -1))
    return up if decoder and up != -1 else int(cfg.get("num_heads", 1))


def _blocks(cfg: dict) -> list[dict]:
    """The UNet's blocks in the order the forward runs them, each ``{name,
    kind, ci, co, decoder, skip}``: kind "conv_in", "res", "down", "up",
    "skip_res" (a decoder ResBlock on the concatenated skip), "attn" or
    "out"; the names are those of the reference torch layout; ``skip``
    marks the last block of an input block, whose output the decoder
    takes."""
    ch0, nrb = int(cfg["num_channels"]), int(cfg["num_res_blocks"])
    mults, att = cwdm._mults(cfg), attention_ds(cfg)
    out = []

    def add(name, kind, ci, co, decoder=False, skip=False):
        out.append(dict(name=name, kind=kind, ci=ci, co=co, decoder=decoder, skip=skip))

    add("input_blocks.0.0", "conv_in", int(cfg["in_channels"]), ch0, skip=True)
    ch, skips, i, ds = ch0, [ch0], 1, 1
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            add(f"input_blocks.{i}.0", "res", ch, mult * ch0, skip=ds not in att)
            ch = mult * ch0
            if ds in att:
                add(f"input_blocks.{i}.1", "attn", ch, ch, skip=True)
            skips.append(ch)
            i += 1
        if level != len(mults) - 1:
            add(f"input_blocks.{i}.0", "down", ch, ch, skip=True)
            skips.append(ch)
            i, ds = i + 1, ds * 2
    mid = ["res"] + (["attn"] if cfg.get("bottleneck_attention", True) else []) + ["res"]
    for j, kind in enumerate(mid):
        add(f"middle_block.{j}", kind, ch, ch)
    i = 0
    for level, mult in reversed(list(enumerate(mults))):
        for k in range(nrb + 1):
            add(f"output_blocks.{i}.0", "skip_res", ch + skips.pop(), mult * ch0, True)
            ch, j = mult * ch0, 1
            if ds in att:
                add(f"output_blocks.{i}.1", "attn", ch, ch, True)
                j += 1
            if level and k == nrb:
                add(f"output_blocks.{i}.{j}", "up", ch, ch, True)
                ds //= 2
            i += 1
    add("out", "out", ch0, int(cfg["out_channels"]))
    return out


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Name → shape of every parameter, in the reference torch layout and the
    order :func:`unet` reads them."""
    check_config(cfg)
    ch0 = int(cfg["num_channels"])
    ted = 4 * ch0
    out = {"time_embed.0.weight": (ted, ch0), "time_embed.0.bias": (ted,),
           "time_embed.2.weight": (ted, ted), "time_embed.2.bias": (ted,)}

    def conv(name, ci, co, k=3):
        out[name + ".weight"], out[name + ".bias"] = (co, ci, k, k, k), (co,)

    for blk in _blocks(cfg):
        name, kind, ci, co = blk["name"], blk["kind"], blk["ci"], blk["co"]
        if kind == "conv_in":
            conv(name, ci, co)
        elif kind == "attn":
            out[name + ".norm.weight"] = out[name + ".norm.bias"] = (ci,)
            out[name + ".qkv.weight"], out[name + ".qkv.bias"] = (3 * ci, ci, 1), (3 * ci,)
            out[name + ".proj_out.weight"], out[name + ".proj_out.bias"] = (ci, ci, 1), (ci,)
        elif kind == "out":
            out["out.0.weight"] = out["out.0.bias"] = (ci,)
            conv("out.2", ci, co)
        else:
            pre = name + "."
            out[pre + "in_layers.0.weight"] = out[pre + "in_layers.0.bias"] = (ci,)
            conv(pre + "in_layers.2", ci, co)
            out[pre + "emb_layers.1.weight"], out[pre + "emb_layers.1.bias"] = (co, ted), (co,)
            out[pre + "out_layers.0.weight"] = out[pre + "out_layers.0.bias"] = (co,)
            conv(pre + "out_layers.3", co, co)
            if ci != co:
                conv(pre + "skip_connection", ci, co, 1)
    return out


def _attention(p, pre, x, groups, heads, new_order, prec):
    """ADM's attention block on ``x`` (B, C, *spatial), float32."""
    b, c, *spatial = x.shape
    flat = x.reshape(b, c, -1)
    t, ch = flat.shape[-1], c // heads
    h = F.group_norm(flat, groups, p[pre + "norm.weight"], p[pre + "norm.bias"], 1e-5)
    qkv = linear(h.transpose(1, 2), p[pre + "qkv.weight"][:, :, 0], p[pre + "qkv.bias"], prec)
    if new_order:
        q, k, v = (u.reshape(b, t, heads, ch) for u in qkv.chunk(3, dim=-1))
    else:
        q, k, v = qkv.reshape(b, t, heads, 3 * ch).chunk(3, dim=-1)
    s = 1.0 / math.sqrt(math.sqrt(ch))
    q, k = cwdm._operands(prec, q * s, k * s)
    a = torch.empty((b, t, heads, ch), device=x.device)
    for i in range(0, t, QUERY_BLOCK):
        w = torch.softmax(torch.einsum("bthc,bshc->bhts", q[:, i:i + QUERY_BLOCK], k), dim=-1)
        w, vv = cwdm._operands(prec, w, v)
        a[:, i:i + QUERY_BLOCK] = torch.einsum("bhts,bshc->bthc", w, vv)
    o = linear(a.reshape(b, t, c), p[pre + "proj_out.weight"][:, :, 0], p[pre + "proj_out.bias"],
               prec)
    return x + o.transpose(1, 2).reshape(b, c, *spatial)


def unet(p: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, prec: str = "fp32"):
    """The UNet on channels-last ``x`` (B, X, Y, Z, Cin) at timesteps ``t``
    (B,) → (B, X, Y, Z, Cout), float32."""
    g, ch0 = int(cfg["num_groups"]), int(cfg["num_channels"])
    new_order = bool(cfg.get("use_new_attention_order", False))
    emb = cwdm.timestep_embedding(t, ch0)
    emb = linear(F.silu(linear(emb, p["time_embed.0.weight"], p["time_embed.0.bias"], prec)),
                 p["time_embed.2.weight"], p["time_embed.2.bias"], prec)
    h, hs = x.permute(0, 4, 1, 2, 3), []
    for blk in _blocks(cfg):
        pre, kind = blk["name"] + ".", blk["kind"]
        if kind == "conv_in":
            h = cwdm.conv3d(h, p[pre + "weight"], p[pre + "bias"], prec)
        elif kind == "attn":
            heads = heads_of(cfg, blk["ci"], blk["decoder"])
            h = _attention(p, pre, h, g, heads, new_order, prec)
        elif kind == "out":
            h = F.silu(F.group_norm(h, g, p["out.0.weight"], p["out.0.bias"], 1e-5))
            return cwdm.conv3d(h, p["out.2.weight"], p["out.2.bias"], prec).permute(0, 2, 3, 4, 1)
        else:
            if kind == "skip_res":
                h = torch.cat([h, hs.pop()], 1)
            h = cwdm._resblock(p, pre, h, emb, g, prec, up=kind == "up", down=kind == "down")
        if blk["skip"]:
            hs.append(h)
    raise ValueError("the block list has no output head")


@torch.no_grad()
def synthesize(p, cfg, cases: dict, mask: torch.Tensor, noise: torch.Tensor,
               step_noise: torch.Tensor, contr: str, crop_z: int, prec: str = "fp32"):
    """``reference/cwdm.py::synthesize`` with this file's UNet: the
    ``diffusion_steps``-step ancestral chain from x_T = ``noise``, then IDWT,
    clamp, mask, crop Z → (B, X, Y, crop_z) float32."""
    steps = int(cfg["diffusion_steps"])
    tabs = cwdm.sampled_tables(steps, noise.device)
    cond = cwdm.condition(cases, contr)
    x = noise
    for k in range(steps):
        t = steps - 1 - k
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        with cwdm.precision(prec):
            x0 = cwdm.project_x0(unet(p, cfg, torch.cat([x, cond], -1), tt, prec))
        x = tabs["coef1"][t] * x0 + tabs["coef2"][t] * x
        if t:
            x = x + torch.exp(0.5 * tabs["log_var"][t]) * step_noise[k]
    img = torch.clamp(cwdm.idwt(x), 0.0, 1.0)
    img = torch.where(mask == 0, 0.0, img)
    return img[..., 0][..., :crop_z]

