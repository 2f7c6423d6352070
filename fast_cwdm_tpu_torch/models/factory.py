"""Model/diffusion construction from the reference flag schema.

Port of ``fast_cwdm_tpu/models/factory.py``: the denoiser
(``UNetModel``, or ``WavUNetModel`` with ``use_freq``), the classifier
(``create_classifier``) and the super-resolution model
(``sr_create_model_and_diffusion``). The same
``model_and_diffusion_defaults`` keys, so CLIs stay flag-compatible, plus
``fuse_gn_silu`` (route every GroupNorm→SiLU site of a ``UNetModel``
through kernel K3) and ``fuse_conv`` (route its ResBlocks' GN→SiLU→conv
chains through K4b).
"""

from __future__ import annotations

import argparse
from ast import literal_eval
from typing import Any

import torch

from fast_cwdm_tpu_torch.diffusion import schedules
from fast_cwdm_tpu_torch.diffusion.gaussian import LossType, MeanType, VarType
from fast_cwdm_tpu_torch.diffusion.respace import create_spaced_diffusion, space_timesteps
from fast_cwdm_tpu_torch.models.unet import EncoderUNetModel, SuperResModel, UNetModel
from fast_cwdm_tpu_torch.models.wunet import WavUNetModel

NUM_CLASSES = 2
DTYPES = {"": None, "none": None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def diffusion_defaults() -> dict[str, Any]:
    return dict(
        learn_sigma=False,
        diffusion_steps=1000,
        noise_schedule="linear",
        timestep_respacing="",
        use_kl=False,
        predict_xstart=False,
        rescale_timesteps=False,
        rescale_learned_sigmas=False,
        dataset="brats",
        dims=3,
        num_groups=32,
        in_channels=1,
    )


def classifier_defaults() -> dict[str, Any]:
    return dict(
        image_size=64,
        classifier_use_fp16=False,
        classifier_width=128,
        classifier_depth=2,
        classifier_attention_resolutions="32,16,8",
        classifier_num_head_channels=64,
        classifier_use_scale_shift_norm=True,
        classifier_resblock_updown=True,
        classifier_pool="spatial",
        classifier_channel_mult="1,1,2,2,4,4",
        dataset="brats",
    )


def model_and_diffusion_defaults() -> dict[str, Any]:
    """Canonical flag schema (the JAX package's, plus ``fuse_gn_silu`` and
    ``fuse_conv``)."""
    res = dict(
        image_size=64,
        num_channels=128,
        num_res_blocks=2,
        num_heads=4,
        num_heads_upsample=-1,
        num_head_channels=-1,
        attention_resolutions="16,8",
        channel_mult="",
        dropout=0.0,
        class_cond=False,
        use_checkpoint=False,
        use_scale_shift_norm=True,
        resblock_updown=True,
        use_fp16=False,
        use_new_attention_order=False,
        dims=3,
        num_groups=32,
        in_channels=1,
        out_channels=0,  # automatically determine if 0
        bottleneck_attention=True,
        resample_2d=True,
        additive_skips=False,
        mode="default",
        use_freq=False,
        predict_xstart=False,
        sample_schedule="direct",
        # compute dtype ("", "float32", "bfloat16"): "" follows use_fp16
        dtype="",
        fuse_gn_silu=False,
        fuse_conv=False,
    )
    res.update(diffusion_defaults())
    return res


def _parse_channel_mult(channel_mult, image_size):
    if not channel_mult:
        presets = {
            512: (1, 1, 2, 2, 4, 4),
            256: (1, 2, 2, 4, 4, 4),
            128: (1, 2, 2, 4, 4),
            64: (1, 2, 3, 4),
        }
        if image_size not in presets:
            raise ValueError(f"[MODEL] Unsupported image size: {image_size}")
        return presets[image_size]
    if isinstance(channel_mult, str):
        return tuple(literal_eval(channel_mult))
    if isinstance(channel_mult, (tuple, list)):
        return tuple(channel_mult)
    raise ValueError(f"[MODEL] Value for {channel_mult=} not supported")


def _attention_ds(attention_resolutions, image_size):
    if not attention_resolutions:
        return ()
    return tuple(image_size // int(r) for r in str(attention_resolutions).split(","))


def parse_dtype(dtype, use_fp16: bool = False) -> torch.dtype | None:
    """"", "float32", "bfloat16" (or a torch dtype / None) → torch dtype.
    ``use_fp16`` maps to bf16 when no explicit dtype is given; an explicit
    "float32" wins over it."""
    if isinstance(dtype, str):
        try:
            dtype = DTYPES[dtype.lower()]
        except KeyError:
            raise ValueError(
                f"[MODEL] dtype must be '', 'float32' or 'bfloat16' (got {dtype!r})"
            ) from None
    if dtype is None and use_fp16:
        dtype = torch.bfloat16
    return dtype


def create_model(
    image_size,
    num_channels,
    num_res_blocks,
    channel_mult="",
    learn_sigma=False,
    class_cond=False,
    use_checkpoint=False,
    attention_resolutions="16",
    num_heads=1,
    num_head_channels=-1,
    num_heads_upsample=-1,
    use_scale_shift_norm=False,
    dropout=0.0,
    resblock_updown=True,
    use_fp16=False,
    use_new_attention_order=False,
    num_groups=32,
    dims=3,
    in_channels=1,
    out_channels=0,
    bottleneck_attention=True,
    resample_2d=True,
    additive_skips=False,
    use_freq=False,
    dtype=None,
    fuse_gn_silu=False,
    fuse_conv=False,
    remat_max_ds=None,
) -> UNetModel | WavUNetModel:
    """Flag-compatible denoiser constructor: ``WavUNetModel(use_freq=True,
    ref_compat=True)`` with ``use_freq`` (the reference decoder's double
    run, so that reference weights keep their forward), else
    ``UNetModel``. ``remat_max_ds`` (None: 1, the JAX package's default)
    bounds the downsample factor of the UNet's ResBlocks that
    ``use_checkpoint`` recomputes; 0 recomputes every one (the WavUNet
    recomputes every block). ``fuse_gn_silu``/``fuse_conv`` are UNet
    routes: with ``use_freq`` they raise, as the JAX package's WavUNet has
    no fused route."""
    if out_channels == 0:
        # Deviation kept from the JAX package (factory.py:198-205): the
        # reference doubles twice on the auto path; auto means "data
        # channels", and the single learn_sigma doubling below is the one.
        out_channels = in_channels
    common = dict(
        image_size=image_size,
        in_channels=in_channels,
        model_channels=num_channels,
        out_channels=out_channels * (2 if learn_sigma else 1),
        num_res_blocks=num_res_blocks,
        attention_resolutions=_attention_ds(attention_resolutions, image_size),
        dropout=dropout,
        channel_mult=_parse_channel_mult(channel_mult, image_size),
        dims=dims,
        num_classes=(NUM_CLASSES if class_cond else None),
        use_checkpoint=use_checkpoint,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
        num_groups=num_groups,
        bottleneck_attention=bottleneck_attention,
        resample_2d=resample_2d,
        additive_skips=additive_skips,
        dtype=parse_dtype(dtype, use_fp16),
    )
    if use_freq:
        if fuse_gn_silu or fuse_conv:
            raise ValueError("fuse_gn_silu and fuse_conv are UNetModel routes; the WavUNetModel "
                             "(use_freq=True) has none")
        return WavUNetModel(use_freq=True, ref_compat=True, **common)
    return UNetModel(
        conv_resample=True,
        fuse_gn_silu=fuse_gn_silu,
        fuse_conv=fuse_conv,
        remat_max_ds=1 if remat_max_ds is None else int(remat_max_ds),
        **common,
    )


def create_gaussian_diffusion(
    *,
    steps=1000,
    learn_sigma=False,
    sigma_small=False,
    noise_schedule="linear",
    use_kl=False,
    predict_xstart=False,
    rescale_timesteps=False,
    rescale_learned_sigmas=False,
    timestep_respacing="",
    mode="default",
    sample_schedule="direct",
    wavelet="haar",
    **unused,
):
    betas = schedules.get_named_beta_schedule(noise_schedule, steps, sample_schedule)
    if use_kl:
        loss_type = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss_type = LossType.RESCALED_MSE
    else:
        loss_type = LossType.MSE
    return create_spaced_diffusion(
        use_timesteps=space_timesteps(steps, timestep_respacing or [steps]),
        betas=betas,
        mean_type=(MeanType.START_X if predict_xstart else MeanType.EPSILON),
        var_type=(
            (VarType.FIXED_LARGE if not sigma_small else VarType.FIXED_SMALL)
            if not learn_sigma
            else VarType.LEARNED_RANGE
        ),
        loss_type=loss_type,
        rescale_timesteps=rescale_timesteps,
        mode=mode,
        wavelet=wavelet,
    )


_MODEL_KEYS = (
    "channel_mult", "learn_sigma", "class_cond", "use_checkpoint",
    "attention_resolutions", "num_heads", "num_head_channels",
    "num_heads_upsample", "use_scale_shift_norm", "dropout", "resblock_updown",
    "use_fp16", "use_new_attention_order", "dims", "num_groups", "in_channels",
    "out_channels", "bottleneck_attention", "resample_2d", "additive_skips",
    "use_freq", "dtype", "fuse_gn_silu", "fuse_conv",
)


def create_model_and_diffusion(**cfg):
    """Accepts the full ``model_and_diffusion_defaults()`` key set (extra
    keys are ignored)."""
    merged = {**model_and_diffusion_defaults(), **cfg}
    model = create_model(
        merged["image_size"], merged["num_channels"], merged["num_res_blocks"],
        **{k: merged[k] for k in _MODEL_KEYS}, remat_max_ds=merged.get("remat_max_ds"),
    )
    diffusion = create_gaussian_diffusion(
        steps=merged["diffusion_steps"],
        learn_sigma=merged["learn_sigma"],
        noise_schedule=merged["noise_schedule"],
        use_kl=merged["use_kl"],
        predict_xstart=merged["predict_xstart"],
        rescale_timesteps=merged["rescale_timesteps"],
        rescale_learned_sigmas=merged["rescale_learned_sigmas"],
        timestep_respacing=merged["timestep_respacing"],
        mode=merged["mode"],
        sample_schedule=merged["sample_schedule"],
    )
    return model, diffusion


def _diffusion_of(merged: dict):
    """The process of a merged flag dict, with the schema's diffusion
    keys."""
    return create_gaussian_diffusion(
        steps=merged["diffusion_steps"],
        learn_sigma=merged["learn_sigma"],
        noise_schedule=merged["noise_schedule"],
        use_kl=merged["use_kl"],
        predict_xstart=merged["predict_xstart"],
        rescale_timesteps=merged["rescale_timesteps"],
        rescale_learned_sigmas=merged["rescale_learned_sigmas"],
        timestep_respacing=merged["timestep_respacing"],
    )


def create_classifier(
    image_size,
    classifier_use_fp16,
    classifier_width,
    classifier_depth,
    classifier_attention_resolutions,
    classifier_use_scale_shift_norm,
    classifier_resblock_updown,
    classifier_pool,
    dataset="brats",
    num_groups=32,
    dims=3,
    in_channels=1,
    num_head_channels=64,
    classifier_channel_mult="",
) -> EncoderUNetModel:
    """The noisy-image classifier, an ``EncoderUNetModel`` with 2 classes
    (``classifier_use_fp16`` and ``dataset`` are accepted and unused, as
    in the JAX package)."""
    channel_mult = classifier_channel_mult
    if not channel_mult:
        presets = {256: (1, 1, 2, 2, 4, 4), 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}
        if image_size not in presets:
            raise ValueError(f"unsupported image size: {image_size}")
        channel_mult = presets[image_size]
    elif isinstance(channel_mult, str):
        channel_mult = tuple(literal_eval(channel_mult))
    return EncoderUNetModel(
        image_size=image_size,
        in_channels=in_channels,
        model_channels=classifier_width,
        out_channels=NUM_CLASSES,
        num_res_blocks=classifier_depth,
        attention_resolutions=_attention_ds(classifier_attention_resolutions, image_size),
        channel_mult=channel_mult,
        num_head_channels=num_head_channels,
        use_scale_shift_norm=classifier_use_scale_shift_norm,
        resblock_updown=classifier_resblock_updown,
        pool=classifier_pool,
        num_groups=num_groups,
        dims=dims,
    )


def classifier_and_diffusion_defaults() -> dict[str, Any]:
    res = classifier_defaults()
    res.update(diffusion_defaults())
    return res


def create_classifier_and_diffusion(**cfg):
    merged = {**classifier_and_diffusion_defaults(), **cfg}
    classifier = create_classifier(
        merged["image_size"],
        merged["classifier_use_fp16"],
        merged["classifier_width"],
        merged["classifier_depth"],
        merged["classifier_attention_resolutions"],
        merged["classifier_use_scale_shift_norm"],
        merged["classifier_resblock_updown"],
        merged["classifier_pool"],
        merged["dataset"],
        dims=merged["dims"],
        num_groups=merged["num_groups"],
        in_channels=merged["in_channels"],
        num_head_channels=merged["classifier_num_head_channels"],
        classifier_channel_mult=merged["classifier_channel_mult"],
    )
    return classifier, _diffusion_of(merged)


def sr_model_and_diffusion_defaults() -> dict[str, Any]:
    res = model_and_diffusion_defaults()
    res["large_size"] = 256
    res["small_size"] = 64
    for k in ("image_size", "channel_mult", "out_channels", "in_channels"):
        res.pop(k, None)
    return res


def sr_create_model_and_diffusion(**cfg):
    """The 2-D ``SuperResModel`` (3 image channels + 3 of the upsampled
    low-res image) and its process."""
    merged = {**sr_model_and_diffusion_defaults(), **cfg}
    large = merged["large_size"]
    presets = {512: (1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4), 64: (1, 2, 3, 4)}
    if large not in presets:
        raise ValueError(f"unsupported large size: {large}")
    model = SuperResModel(
        image_size=large,
        in_channels=6,
        model_channels=merged["num_channels"],
        out_channels=(3 if not merged["learn_sigma"] else 6),
        num_res_blocks=merged["num_res_blocks"],
        attention_resolutions=_attention_ds(merged["attention_resolutions"], large),
        dropout=merged["dropout"],
        channel_mult=presets[large],
        num_classes=(NUM_CLASSES if merged["class_cond"] else None),
        dims=2,
        num_heads=merged["num_heads"],
        num_head_channels=merged["num_head_channels"],
        num_heads_upsample=merged["num_heads_upsample"],
        use_scale_shift_norm=merged["use_scale_shift_norm"],
        resblock_updown=merged["resblock_updown"],
        num_groups=merged.get("num_groups", 32),
    )
    return model, _diffusion_of(merged)


def add_dict_to_argparser(parser: argparse.ArgumentParser, default_dict):
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args, keys):
    return {k: getattr(args, k) for k in keys}


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")
