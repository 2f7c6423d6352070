"""The hand-written CUDA kernels K1/K2/K3 on the card: each against its
plain torch version, their wrappers' refusals, and the autograd pair.

Marked ``cuda``: skipped where no GPU is present. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(1, 16, 12, 8), (2, 3, 8, 10, 6)])
def test_haar_kernels_match_plain(gen, shape):
    x = torch.rand(shape, generator=gen, device="cuda")
    before = (wc.haar_dwt3.launches, wc.haar_idwt3.launches)
    y = wc.haar_dwt3(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, wc.haar_dwt3_plain(x), atol=1e-5, rtol=0)
    back = wc.haar_idwt3(y)
    torch.testing.assert_close(back, wc.haar_idwt3_plain(y), atol=1e-5, rtol=0)
    torch.testing.assert_close(back, x, atol=1e-5, rtol=0)
    assert (wc.haar_dwt3.launches, wc.haar_idwt3.launches) == (before[0] + 1, before[1] + 1)


def test_dwt3_flat_routes_to_the_kernel(gen):
    x = torch.rand((1, 8, 8, 8, 1), generator=gen, device="cuda")
    before = wc.haar_dwt3.launches
    ours = wv.dwt3_flat(x)
    assert wc.haar_dwt3.launches == before + 1
    torch.testing.assert_close(ours, wv.dwt3_flat(x, impl="xla"), atol=1e-5, rtol=0)


def test_autograd_pair_backward_launches_the_other_kernel(gen):
    x = torch.rand((1, 8, 8, 8), generator=gen, device="cuda", requires_grad=True)
    w = torch.rand((1, 4, 4, 4, 8), generator=gen, device="cuda")
    before = wc.haar_idwt3.launches
    (wc.HaarDWT3.apply(x) * w).sum().backward()
    assert wc.haar_idwt3.launches == before + 1
    torch.testing.assert_close(x.grad, wc.haar_idwt3_plain(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 6, 6, 4), (1, 3, 5, 3, 3)])
def test_affine_silu_matches_plain(gen, dtype, channels_last, shape):
    """Vector path (64 channels) and element path (3 channels, odd sizes);
    the same fp32 operations on both sides, so equal bit for bit."""
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    a = torch.randn(shape[:2], generator=gen, device="cuda")
    b = torch.randn(shape[:2], generator=gen, device="cuda")
    before = ec.affine_silu.launches
    y = ec.affine_silu(x, a, b)
    torch.cuda.synchronize()
    assert ec.affine_silu.launches == before + 1
    assert y.dtype == dtype and y.stride() == x.stride()
    torch.testing.assert_close(y, ec.affine_silu_plain(x, a, b), atol=0, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = torch.rand((1, 8, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        wc.haar_dwt3(x.double())
    with pytest.raises(ValueError):
        wc.haar_dwt3(x.transpose(1, 2))
    with pytest.raises(ValueError):
        wc.haar_idwt3(torch.zeros((1, 2, 2, 2, 8), device="cuda").transpose(1, 2))
    h = torch.zeros((1, 8, 4, 4, 4), device="cuda")
    with pytest.raises(TypeError):
        ec.affine_silu(h.half(), torch.ones(1, 8, device="cuda"), torch.zeros(1, 8, device="cuda"))
    with pytest.raises(ValueError):
        ec.affine_silu(h.transpose(2, 3), torch.ones(1, 8, device="cuda"),
                       torch.zeros(1, 8, device="cuda"))
    with pytest.raises(ValueError):
        ec.affine_silu(h, torch.ones(8, device="cuda"), torch.zeros(1, 8, device="cuda"))
