"""The port's GN-apply+SiLU (plain path of kernel K3, taken for CPU tensors)
against the JAX package's Pallas kernel in interpret mode, and the port's
GroupNorm32 against the JAX module.

Tolerances: fp32 1e-5 (same formula, summation order differs); bf16 one
bf16 ulp of the output (both compute in fp32 and round once, so at most a
rounding-boundary flip apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.models.nn import GroupNorm32 as JGroupNorm32
from fast_cwdm_tpu.ops import elementwise_pallas as ep
from fast_cwdm_tpu_torch.models.nn import GroupNorm32
from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(ep, "INTERPRET", True)


def _ncdhw(a_last: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """channels-last numpy → logical NCDHW torch view (channels_last_3d)."""
    return torch.from_numpy(np.array(a_last)).to(dtype).permute(0, 4, 1, 2, 3)


def _last(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 4, 1).float().numpy()


def _assert_within_bf16_ulp(ours: np.ndarray, ref: np.ndarray):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert np.all(np.abs(ours - ref) <= ulp), np.max(np.abs(ours - ref) / ulp)


@pytest.mark.parametrize("c", [64, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_silu_matches_pallas_kernel(c, dtype):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, 8, 8, 4, c)).astype(np.float32)
    a = rng.standard_normal((1, c)).astype(np.float32)
    b = rng.standard_normal((1, c)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    assert ep.supported(jx.shape)
    ref = np.asarray(ep.affine_silu(jx, jnp.asarray(a), jnp.asarray(b)), np.float32)
    tx = _ncdhw(np.asarray(jx, np.float32), getattr(torch, dtype))
    ours = ec.affine_silu(tx, torch.from_numpy(a), torch.from_numpy(b))
    assert ours.dtype == tx.dtype and ours.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(_last(ours), ref, atol=1e-5)
    else:
        _assert_within_bf16_ulp(_last(ours), ref)


def test_affine_silu_any_batch_and_both_memory_formats():
    """B = 2 (the JAX kernel takes B = 1 only; the port takes any B), in
    contiguous and channels_last_3d memory, against the JAX reference
    formula."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 4, 4, 64)).astype(np.float32)
    a = rng.standard_normal((2, 64)).astype(np.float32)
    b = rng.standard_normal((2, 64)).astype(np.float32)
    ref = np.asarray(ep._reference(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    tx = _ncdhw(x)
    for t in (tx, tx.contiguous()):
        ours = ec.affine_silu(t, torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(_last(ours), ref, atol=1e-5)


def test_gn_apply_silu_matches_pallas():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 4, 4, 4, 64)).astype(np.float32)
    mean = rng.standard_normal((1, 64)).astype(np.float32)
    rstd = rng.random((1, 64)).astype(np.float32) + 0.5
    scale = rng.random(64).astype(np.float32) + 0.5
    bias = rng.standard_normal(64).astype(np.float32)
    ref = ep.gn_apply_silu(*(jnp.asarray(v) for v in (x, mean, rstd, scale, bias)))
    ours = ec.gn_apply_silu(_ncdhw(x), *(torch.from_numpy(v) for v in (mean, rstd, scale, bias)))
    np.testing.assert_allclose(_last(ours), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm32_matches_jax(act, dtype):
    """``act=None`` is the unfused norm; ``act="silu"`` the fused route
    (Pallas kernel in interpret mode on the JAX side)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((1, 8, 8, 4, 64)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    assert ep.supported(jx.shape)  # else JAX takes its unfused path
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    ref = np.asarray(JGroupNorm32(32).apply(params, jx, act=act), np.float32)

    gn = GroupNorm32(32, 64)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        ours = _last(gn(_ncdhw(np.asarray(jx, np.float32), getattr(torch, dtype)), act=act))
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=1e-5)
    else:
        # stats agree to fp32 rounding; the bf16 output may then land one
        # ulp apart
        _assert_within_bf16_ulp(ours, ref)


def test_cpu_tensor_counts_no_launch():
    before = ec.affine_silu.launches
    ec.affine_silu(torch.zeros(1, 8, 2, 2, 2), torch.ones(1, 8), torch.zeros(1, 8))
    assert ec.affine_silu.launches == before


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ec.affine_silu(torch.zeros(8), torch.ones(1, 8), torch.zeros(1, 8))
    assert jax.default_backend() == "cpu"


def test_cpu_path_stays_differentiable():
    """On the CPU affine_silu is the plain version, differentiable, with the
    gradients of the JAX package's custom VJP (the card refuses backward:
    tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, 4, 4, 64)).astype(np.float32)
    a = rng.standard_normal((1, 64)).astype(np.float32)
    b = rng.standard_normal((1, 64)).astype(np.float32)
    ref = jax.grad(lambda *v: jnp.sum(jnp.sin(ep.affine_silu(*v))), argnums=(0, 1, 2))(
        *(jnp.asarray(v) for v in (x, a, b)))
    tx = _ncdhw(x).requires_grad_()
    ta, tb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    torch.sin(ec.affine_silu(tx, ta, tb)).sum().backward()
    np.testing.assert_allclose(_last(tx.grad), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref[2]), atol=1e-4)
