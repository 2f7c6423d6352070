"""The port's wavelet ops (plain torch path, taken for CPU tensors) against
the JAX package: the XLA slice path and the Pallas kernels K1/K2 in
interpret mode, at atol 1e-5 (fp32, the same butterflies)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.ops import wavelet as jwv
from fast_cwdm_tpu.ops import wavelet_pallas as jwp
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.ops import wavelet_cuda

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.fixture(scope="module")
def vol():
    return np.random.default_rng(0).standard_normal((2, 8, 16, 12, 1)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_filter_bank_and_banded_matrices_match():
    for name in ("haar", "db2", "db4"):
        for a, b in zip(wv.filter_bank(name), jwv.filter_bank(name)):
            np.testing.assert_allclose(a, b, atol=1e-12)
        for a, b in zip(wv._banded_matrices(12, name), jwv._banded_matrices(12, name)):
            np.testing.assert_allclose(a, b, atol=1e-12)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_dwt3_flat_matches_jax(vol, reference):
    ours = wv.dwt3_flat(_t(vol)).numpy()
    if reference == "xla":
        ref = np.asarray(jwv.dwt3_flat(jnp.asarray(vol), impl="xla"))
    else:
        ref = np.asarray(jwp.dwt3_flat_pallas(jnp.asarray(vol), interpret=True))
    assert ours.shape == ref.shape == (2, 4, 8, 6, 8)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_idwt3_flat_matches_jax(vol, reference):
    bands = np.asarray(jwv.dwt3_flat(jnp.asarray(vol), impl="xla"))
    ours = wv.idwt3_flat(_t(bands)).numpy()
    if reference == "xla":
        ref = np.asarray(jwv.idwt3_flat(jnp.asarray(bands), impl="xla"))
    else:
        ref = np.asarray(jwp.idwt3_flat_pallas(jnp.asarray(bands), interpret=True))
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("wavelet,channels", [("haar", 3), ("db2", 1)])
def test_multichannel_and_daubechies_match_jax(wavelet, channels):
    x = np.random.default_rng(1).standard_normal((1, 8, 8, 12, channels)).astype(np.float32)
    ours = wv.dwt3_flat(_t(x), wavelet)
    ref = jwv.dwt3_flat(jnp.asarray(x), wavelet, impl="xla")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    back = wv.idwt3_flat(ours, channels, wavelet).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jwv.idwt3_flat(ref, channels, wavelet, impl="xla")), atol=ATOL
    )


def test_roundtrip_exact(vol):
    x = _t(vol)
    np.testing.assert_allclose(wv.idwt3_flat(wv.dwt3_flat(x)).numpy(), vol, atol=ATOL)


def test_normalized_and_clamp_project_match_jax(vol):
    x = np.clip(vol * 0.3 + 0.5, 0.0, 1.0)
    ours = wv.dwt_normalized(_t(x))
    ref = jwv.dwt_normalized(jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(
        wv.idwt_normalized(ours).numpy(), np.asarray(jwv.idwt_normalized(ref)), atol=ATOL
    )
    lat = np.random.default_rng(2).standard_normal((1, 4, 4, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        wv.haar_clamp_project(_t(lat)).numpy(),
        np.asarray(jwv.haar_clamp_project(jnp.asarray(lat))),
        atol=ATOL,
    )
    # the fused projection equals the spatial IDWT → clamp → DWT round trip
    spatial = wv.dwt_normalized(torch.clamp(wv.idwt_normalized(_t(lat)), 0.0, 1.0))
    np.testing.assert_allclose(wv.haar_clamp_project(_t(lat)).numpy(), spatial.numpy(), atol=ATOL)


def test_impl_errors_match_jax_contract(vol):
    with pytest.raises(ValueError, match="Haar-only"):
        wv.dwt3_flat(_t(vol), "db2", impl="pallas")
    with pytest.raises(ValueError, match="single-channel"):
        wv.dwt3_flat(torch.zeros(1, 4, 4, 4, 2), impl="pallas")
    with pytest.raises(ValueError, match="Haar-only"):
        wv.idwt3_flat(torch.zeros(1, 2, 2, 2, 8), wavelet="db2", impl="pallas")
    with pytest.raises(ValueError, match="single-channel"):
        wv.idwt3_flat(torch.zeros(1, 2, 2, 2, 16), channels=2, impl="pallas")
    with pytest.raises(ValueError, match="odd size"):
        wv.dwt3_flat(torch.zeros(1, 4, 5, 4, 1), impl="xla")


def test_autograd_pair_matches_jax_grad(vol):
    """HaarDWT3/HaarIDWT3 gradients against jax.grad through the Pallas
    kernels' custom VJPs (interpret mode)."""
    x = vol[..., 0]
    w = np.random.default_rng(3).standard_normal((2, 4, 8, 6, 8)).astype(np.float32)

    def jloss(v):
        bands = jnp.moveaxis(jwp.dwt3_pallas(v, True), -4, -1)
        return jnp.sum(jnp.sin(bands) * w)

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (torch.sin(wavelet_cuda.HaarDWT3.apply(xt)) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, atol=1e-5)

    def jloss_inv(b):
        img = jwp.idwt3_pallas(jnp.moveaxis(b, -1, -4), True)
        return jnp.sum(jnp.sin(img) * x)

    g_ref = np.asarray(jax.grad(jloss_inv)(jnp.asarray(w)))
    wt = _t(w).requires_grad_(True)
    (torch.sin(wavelet_cuda.HaarIDWT3.apply(wt)) * _t(x)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), g_ref, atol=1e-5)


def test_cpu_tensor_takes_plain_path_and_counts_nothing(vol):
    before = (wavelet_cuda.haar_dwt3.launches, wavelet_cuda.haar_idwt3.launches)
    y = wavelet_cuda.haar_dwt3(_t(vol[..., 0]))
    wavelet_cuda.haar_idwt3(y)
    assert (wavelet_cuda.haar_dwt3.launches, wavelet_cuda.haar_idwt3.launches) == before
