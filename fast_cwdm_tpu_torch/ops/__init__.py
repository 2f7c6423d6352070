"""Wavelet transforms and the hand-written CUDA kernels (K1-K5 and the K3
VJP), with one view of the wrappers' launch counters."""

from __future__ import annotations

from fast_cwdm_tpu_torch.ops.wavelet import (  # noqa: F401
    LLL_SCALE,
    dwt1,
    dwt2,
    dwt2_tiny,
    dwt3,
    dwt3_flat,
    dwt_normalized,
    filter_bank,
    haar_clamp_project,
    idwt1,
    idwt2,
    idwt3,
    idwt3_flat,
    idwt_normalized,
    scale_lll,
)


def _counters() -> dict:
    """name → (holder, attribute or key) of every wrapper's launch counter."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    return {
        "haar_dwt3": (wc.haar_dwt3, "launches"),
        "haar_idwt3": (wc.haar_idwt3, "launches"),
        "affine_silu": (ec.affine_silu, "launches"),
        "affine_silu_bwd": (ec.affine_silu_bwd, "launches"),
        "conv3d_fused_k4a": (tc.conv3d_fused, "launches_k4a"),
        "conv3d_fused_k4b": (tc.conv3d_fused, "launches_k4b"),
        "conv3d_fused_v4": (tc.conv3d_fused_v4, "launches"),
        **{k: (tc.kernel_launches, k) for k in tc.kernel_launches},
    }


def launch_counts() -> dict[str, int]:
    """Every launch counter by name: K1, K2, K3 and its VJP, the fused conv
    by entry point (``conv3d_fused_k4a``/``_k4b``/``_v4``) and by kernel
    (``conv3d_wgmma``, ``conv3d_splitk``, ``conv3d_mma_sync``)."""
    return {name: h[k] if isinstance(h, dict) else getattr(h, k)
            for name, (h, k) in _counters().items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Set the named counters to the given values; the others keep theirs."""
    counters = _counters()
    for name, value in counts.items():
        h, k = counters[name]
        if isinstance(h, dict):
            h[k] = value
        else:
            setattr(h, k, value)
