"""fast-cwdm-tpu-torch: the PyTorch/CUDA port of ``fast_cwdm_tpu``.

Conditional 3D Haar-wavelet diffusion for BraTS missing-modality synthesis,
running on an NVIDIA H100 (sm_90a). The JAX package beside it is the
reference this port is held against; nothing here imports it.

- ``ops``       Haar DWT/IDWT (plain torch + CUDA kernels K1/K2), fused
                GroupNorm-apply+SiLU (plain torch + CUDA kernel K3)
- ``models``    3D ``UNetModel`` with the reference torch parameter layout
- ``diffusion`` beta schedules, respacing, ancestral sampling loop
- ``data``      NIfTI IO and BraTS eval preprocessing (numpy only)
- ``cli``       synthesis plumbing and the ``sample`` entry point

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
