"""fast-cwdm-tpu-torch: the PyTorch/CUDA port of ``fast_cwdm_tpu``.

Conditional 3D Haar-wavelet diffusion for BraTS missing-modality synthesis,
running on an NVIDIA H100 (sm_90a). The JAX package beside it is the
reference this port is held against; nothing here imports it.

- ``ops``       1-, 2- and 3-D wavelets; Haar DWT/IDWT (plain torch +
                CUDA kernels K1/K2), fused GroupNorm-apply+SiLU and its
                VJP (plain torch + CUDA kernel K3 and its VJP kernel),
                fused GN→SiLU→3³ conv (plain torch + three CUDA kernels
                for K4a/K4b/K5)
- ``models``    the UNet denoiser (attention, class conditioning, dims
                1-3), the wavelet U-Net, the classifier and
                super-resolution models, with the reference torch
                parameter layout and the JAX weights both ways; gradient
                checkpointing
- ``diffusion`` beta schedules, respacing, ancestral, DDIM and
                DPM-Solver++ sampling loops (with classifier guidance),
                known-image, interpolation and progressive loops, the
                variational bound, the chain as replays of one captured
                CUDA graph, the training loss, timestep samplers
- ``data``      NIfTI IO, BraTS preprocessing and un-crop, training
                batches, prefetch loaders
- ``training``  the train step (AdamW as optax's, EMA), the training loop,
                the JAX package's ``.ckpt`` format (numpy msgpack codec),
                BEST discovery and saving
- ``parallel``  the data axis over ``torch.distributed`` (one process per
                GPU under torchrun), the multi-process dry run
- ``cli``       synthesis plumbing and the ``sample``, ``complete_dataset``,
                ``sample_auto``, ``convert_checkpoint`` and ``train`` entry
                points
- ``utils``     the kv logger, device time (``devtime``), traces and the
                ``[PROFILE]`` step timer, seeded test weights

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default)
    and no GPU is present — nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fast_cwdm_tpu_torch runs on CUDA by default and no GPU is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
