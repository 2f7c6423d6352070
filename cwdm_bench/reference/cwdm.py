"""Plain PyTorch reference of the cWDM production path, for deciding ``correct``.

A frozen, stand-alone copy of the mathematics the benchmark compares the
program against. It imports torch and numpy only: nothing of the program,
of the JAX package or of ``jax``. Everything is float32 (TF32 off); what it
needs beyond the weights and the inputs (the schedule, the condition, every
derived tensor) it works out itself.

- the production UNet (``num_channels`` 64, ``channel_mult`` 1,2,2,4,4, two
  ResBlocks a level, ResBlock up/down sampling, no attention, no scale-shift)
  as functions over a state dict in the reference torch layout;
- the orthonormal 3-D Haar transform with the network's LLL/3 convention;
- the Fast-DDPM "sampled" linear schedule, the ancestral (ddpm) step with
  x0-prediction, the fixed-large variance and the x0 projection
  (IDWT → clamp to [0, 1] → DWT);
- the x0 MSE in wavelet space, optax's AdamW with the linear anneal and the
  warmed-up EMA.

``prec`` selects the precision of the convolutions and dense layers:
``"fp32"`` (the reference), ``"tf32"`` (TF32 tensor-core products, the
control of a float32 configuration) or ``"fp8"`` (operands rounded to
float8 e4m3 with a per-tensor scale, the control of a bfloat16 one).
Everything else stays float32 in every precision.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

MODALITIES = ("t1n", "t1c", "t2w", "t2f")
LLL_SCALE = 3.0
FP8_MAX = 448.0  # largest finite float8 e4m3


@contextlib.contextmanager
def precision(prec: str):
    """TF32 on only for ``prec == "tf32"``; restored on exit."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = prec == "tf32"
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale to its largest
    magnitude, back in float32. The rounding is seen by the products only:
    the gradient passes it unchanged (a float8 cast inside autograd would
    round the gradient too, unscaled, and zero it)."""
    with torch.no_grad():
        s = FP8_MAX / t.abs().amax().clamp_min(1e-30)
        q = (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return t + (q - t).detach() if t.requires_grad else q


def _operands(prec, *ts):
    return tuple(_fp8(t) for t in ts) if prec == "fp8" else ts


def conv3d(x, w, b, prec="fp32", stride=1):
    x, w = _operands(prec, x, w)
    return F.conv3d(x, w, b, stride=stride, padding=(w.shape[-1] - 1) // 2)


def linear(x, w, b, prec="fp32"):
    x, w = _operands(prec, x, w)
    return F.linear(x, w, b)


# -- Haar ------------------------------------------------------------------

def _mixing(device) -> torch.Tensor:
    """M[band, corner] of one 2×2×2 block: band = 4·hi(X) + 2·hi(Y) + hi(Z),
    corner = 4·odd(X) + 2·odd(Y) + odd(Z); orthonormal and symmetric."""
    m = np.array([[(-1.0) ** bin(b & c).count("1") for c in range(8)] for b in range(8)])
    return torch.tensor(m / (2.0 * math.sqrt(2.0)), dtype=torch.float32, device=device)


def dwt(v: torch.Tensor, lll: float = 1.0 / LLL_SCALE) -> torch.Tensor:
    """(B, X, Y, Z, 1) → (B, X/2, Y/2, Z/2, 8) subbands, LLL times ``lll``."""
    b, x, y, z, _ = v.shape
    corners = v.reshape(b, x // 2, 2, y // 2, 2, z // 2, 2).permute(0, 1, 3, 5, 2, 4, 6)
    bands = corners.reshape(b, x // 2, y // 2, z // 2, 8) @ _mixing(v.device).T
    scale = torch.ones(8, device=v.device)
    scale[0] = lll
    return bands * scale


def idwt(bands: torch.Tensor, lll: float = LLL_SCALE) -> torch.Tensor:
    """Inverse of :func:`dwt`: (B, X, Y, Z, 8), LLL times ``lll`` first →
    (B, 2X, 2Y, 2Z, 1)."""
    b, x, y, z, _ = bands.shape
    scale = torch.ones(8, device=bands.device)
    scale[0] = lll
    corners = (bands * scale) @ _mixing(bands.device)
    v = corners.reshape(b, x, y, z, 2, 2, 2).permute(0, 1, 4, 2, 5, 3, 6)
    return v.reshape(b, 2 * x, 2 * y, 2 * z, 1)


def condition(cases: dict, contr: str) -> torch.Tensor:
    """The 24-channel condition of the three known modalities, in the
    modality order with ``contr`` left out."""
    return torch.cat([dwt(cases[m]) for m in MODALITIES if m != contr], dim=-1)


# -- schedule --------------------------------------------------------------

def sampled_tables(steps: int, device) -> dict[str, torch.Tensor]:
    """Fast-DDPM's sampled linear schedule at ``steps`` steps: ``steps``
    evenly spaced points of the 1000-step linear ᾱ curve, betas from their
    ratios, clipped to [1e-4, 0.999]; the tables in float64, kept as float32."""
    full = np.cumprod(1.0 - np.linspace(0.0001, 0.02, 1000, dtype=np.float64))
    acp_s = full[np.linspace(0, 999, steps, dtype=int)]
    betas = np.clip(1.0 - acp_s / np.concatenate([[1.0], acp_s[:-1]]), 0.0001, 0.999)
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    tabs = {
        "sqrt_acp": np.sqrt(acp),
        "sqrt_1m_acp": np.sqrt(1.0 - acp),
        "coef1": betas * np.sqrt(acp_prev) / (1.0 - acp),
        "coef2": (1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp),
        "log_var": np.log(np.append(post_var[1], betas[1:])),  # fixed-large
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in tabs.items()}


# -- UNet ------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def check_config(cfg: dict) -> None:
    """The reference covers the production family only."""
    want = dict(attention_resolutions="", bottleneck_attention=False, resample_2d=False,
                use_scale_shift_norm=False, additive_skips=False, dims=3, mode="i2i",
                predict_xstart=True, noise_schedule="linear", sample_schedule="sampled")
    bad = {k: cfg.get(k) for k, v in want.items() if cfg.get(k, v) != v}
    if bad or not cfg.get("resblock_updown", True):
        raise ValueError(f"the reference covers the production UNet only; config has {bad}")


def _mults(cfg) -> tuple[int, ...]:
    m = cfg["channel_mult"]
    return tuple(int(s) for s in m.split(",")) if isinstance(m, str) else tuple(m)


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Name → shape of every parameter, in the reference torch layout and the
    order :func:`unet` reads them."""
    check_config(cfg)
    ch0, nrb = int(cfg["num_channels"]), int(cfg["num_res_blocks"])
    ted = 4 * ch0
    out = {"time_embed.0.weight": (ted, ch0), "time_embed.0.bias": (ted,),
           "time_embed.2.weight": (ted, ted), "time_embed.2.bias": (ted,)}

    def conv(name, ci, co, k=3):
        out[name + ".weight"], out[name + ".bias"] = (co, ci, k, k, k), (co,)

    def resblock(pre, ci, co):
        out[pre + "in_layers.0.weight"] = out[pre + "in_layers.0.bias"] = (ci,)
        conv(pre + "in_layers.2", ci, co)
        out[pre + "emb_layers.1.weight"], out[pre + "emb_layers.1.bias"] = (co, ted), (co,)
        out[pre + "out_layers.0.weight"] = out[pre + "out_layers.0.bias"] = (co,)
        conv(pre + "out_layers.3", co, co)
        if ci != co:
            conv(pre + "skip_connection", ci, co, 1)
        return co

    conv("input_blocks.0.0", int(cfg["in_channels"]), ch0)
    ch, skips, i, mults = ch0, [ch0], 1, _mults(cfg)
    for level, mult in enumerate(mults):
        for _ in range(nrb):
            ch = resblock(f"input_blocks.{i}.0.", ch, mult * ch0)
            skips.append(ch)
            i += 1
        if level != len(mults) - 1:
            resblock(f"input_blocks.{i}.0.", ch, ch)
            skips.append(ch)
            i += 1
    for j in range(2):
        resblock(f"middle_block.{j}.", ch, ch)
    i = 0
    for level, mult in reversed(list(enumerate(mults))):
        for k in range(nrb + 1):
            ch = resblock(f"output_blocks.{i}.0.", ch + skips.pop(), mult * ch0)
            if level and k == nrb:
                resblock(f"output_blocks.{i}.1.", ch, ch)
            i += 1
    out["out.0.weight"] = out["out.0.bias"] = (ch0,)
    conv("out.2", ch0, int(cfg["out_channels"]))
    return out


def _resblock(p, pre, x, emb, groups, prec, up=False, down=False):
    h = F.silu(F.group_norm(x, groups, p[pre + "in_layers.0.weight"],
                            p[pre + "in_layers.0.bias"], 1e-5))
    if up:
        h, x = (F.interpolate(v, scale_factor=2, mode="nearest") for v in (h, x))
    elif down:
        h, x = (F.avg_pool3d(v, 2) for v in (h, x))
    h = conv3d(h, p[pre + "in_layers.2.weight"], p[pre + "in_layers.2.bias"], prec)
    e = linear(F.silu(emb), p[pre + "emb_layers.1.weight"], p[pre + "emb_layers.1.bias"], prec)
    h = h + e[:, :, None, None, None]
    h = F.silu(F.group_norm(h, groups, p[pre + "out_layers.0.weight"],
                            p[pre + "out_layers.0.bias"], 1e-5))
    h = conv3d(h, p[pre + "out_layers.3.weight"], p[pre + "out_layers.3.bias"], prec)
    if pre + "skip_connection.weight" in p:
        x = conv3d(x, p[pre + "skip_connection.weight"], p[pre + "skip_connection.bias"], prec)
    return x + h


def unet(p: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, prec: str = "fp32"):
    """The UNet on channels-last ``x`` (B, X, Y, Z, Cin) at timesteps ``t``
    (B,) → (B, X, Y, Z, Cout), float32."""
    g, ch0, nrb = int(cfg["num_groups"]), int(cfg["num_channels"]), int(cfg["num_res_blocks"])
    mults = _mults(cfg)
    emb = timestep_embedding(t, ch0)
    emb = linear(F.silu(linear(emb, p["time_embed.0.weight"], p["time_embed.0.bias"], prec)),
                 p["time_embed.2.weight"], p["time_embed.2.bias"], prec)
    h = conv3d(x.permute(0, 4, 1, 2, 3), p["input_blocks.0.0.weight"],
               p["input_blocks.0.0.bias"], prec)
    hs, i = [h], 1
    for level in range(len(mults)):
        for _ in range(nrb):
            h = _resblock(p, f"input_blocks.{i}.0.", h, emb, g, prec)
            hs.append(h)
            i += 1
        if level != len(mults) - 1:
            h = _resblock(p, f"input_blocks.{i}.0.", h, emb, g, prec, down=True)
            hs.append(h)
            i += 1
    for j in range(2):
        h = _resblock(p, f"middle_block.{j}.", h, emb, g, prec)
    i = 0
    for level in reversed(range(len(mults))):
        for k in range(nrb + 1):
            h = _resblock(p, f"output_blocks.{i}.0.", torch.cat([h, hs.pop()], 1), emb, g, prec)
            if level and k == nrb:
                h = _resblock(p, f"output_blocks.{i}.1.", h, emb, g, prec, up=True)
            i += 1
    h = F.silu(F.group_norm(h, g, p["out.0.weight"], p["out.0.bias"], 1e-5))
    return conv3d(h, p["out.2.weight"], p["out.2.bias"], prec).permute(0, 2, 3, 4, 1)


# -- synthesis -------------------------------------------------------------

def project_x0(x0: torch.Tensor) -> torch.Tensor:
    """IDWT → clamp to [0, 1] → DWT, in the LLL/3 convention."""
    return dwt(torch.clamp(idwt(x0), 0.0, 1.0))


@torch.no_grad()
def synthesize(p, cfg, cases: dict, mask: torch.Tensor, noise: torch.Tensor,
               step_noise: torch.Tensor, contr: str, crop_z: int, prec: str = "fp32"):
    """The 10-step (``diffusion_steps``) ancestral chain from x_T = ``noise``
    with ``step_noise[k]`` the k-th step's noise, then IDWT, clamp, zero
    where ``mask`` is 0, crop Z → (B, X, Y, crop_z) float32."""
    tabs = sampled_tables(int(cfg["diffusion_steps"]), noise.device)
    cond = condition(cases, contr)
    x = noise
    for k in range(int(cfg["diffusion_steps"])):
        t = int(cfg["diffusion_steps"]) - 1 - k
        tt = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        with precision(prec):
            x0 = project_x0(unet(p, cfg, torch.cat([x, cond], -1), tt, prec))
        x = tabs["coef1"][t] * x0 + tabs["coef2"][t] * x
        if t:
            x = x + torch.exp(0.5 * tabs["log_var"][t]) * step_noise[k]
    img = torch.clamp(idwt(x), 0.0, 1.0)
    img = torch.where(mask == 0, 0.0, img)
    return img[..., 0][..., :crop_z]


# -- training --------------------------------------------------------------

def loss(p, cfg, cases: dict, t: torch.Tensor, noise_img: torch.Tensor, contr: str,
         prec: str = "fp32") -> torch.Tensor:
    """The x0 MSE in wavelet space, the mean of the 8 subbands' means: the
    target's bands (LLL/3) against the UNet's output on q(x_t | x_0), the
    noise transformed without the LLL scaling."""
    tabs = sampled_tables(int(cfg["diffusion_steps"]), t.device)
    x0 = dwt(cases[contr])
    xt = (tabs["sqrt_acp"][t].reshape(-1, 1, 1, 1, 1) * x0
          + tabs["sqrt_1m_acp"][t].reshape(-1, 1, 1, 1, 1) * dwt(noise_img, 1.0))
    with precision(prec):
        out = unet(p, cfg, torch.cat([xt, condition(cases, contr)], -1), t, prec)
    return ((x0 - out) ** 2).mean(dim=(0, 1, 2, 3)).mean()


class AdamW:
    """optax's ``adamw`` with ``lr·(1 − min(count, N)/N)`` at the count before
    the update, then the EMA ``e ← r·e + (1 − r)·p``, ``r = min(rate,
    (1+n)/(10+n))`` after the n-th step."""

    def __init__(self, params: dict, lr: float, anneal: int, ema_rate: float,
                 b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        self.lr, self.anneal, self.rate = lr, anneal, ema_rate
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.ema = {k: v.detach().clone() for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        lr = self.lr
        if self.anneal:
            lr *= 1.0 - min(self.count, self.anneal) / self.anneal
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        r = min(self.rate, (1.0 + self.count) / (10.0 + self.count))
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            u = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(lr * u)
            self.ema[k].mul_(r).add_((1.0 - r) * p)
