"""Model families: the 3-D UNet denoiser, the wavelet U-Net, the classifier
and super-resolution variants, with the reference torch parameter layout."""

from fast_cwdm_tpu_torch.models.factory import (  # noqa: F401
    add_dict_to_argparser,
    args_to_dict,
    classifier_and_diffusion_defaults,
    classifier_defaults,
    create_classifier,
    create_classifier_and_diffusion,
    create_gaussian_diffusion,
    create_model,
    create_model_and_diffusion,
    diffusion_defaults,
    model_and_diffusion_defaults,
    sr_create_model_and_diffusion,
    sr_model_and_diffusion_defaults,
    str2bool,
)
from fast_cwdm_tpu_torch.models.nn import (  # noqa: F401
    GroupNorm32,
    mean_flat,
    timestep_embedding,
)
from fast_cwdm_tpu_torch.models.unet import (  # noqa: F401
    AttentionBlock,
    Downsample,
    EncoderUNetModel,
    ResBlock,
    SuperResModel,
    UNetModel,
    Upsample,
    WaveletGatingDownsample,
    WaveletGatingUpsample,
)
from fast_cwdm_tpu_torch.models.wunet import (  # noqa: F401
    WavResBlock,
    WavUNetModel,
    WaveletDownsample,
)
