"""The port's GN-apply+SiLU (plain path of kernel K3, taken for CPU tensors)
against the JAX package's Pallas kernel in interpret mode, its VJP (the
plain version of the K3 VJP kernel, and backward() through the port's
autograd Function) against ``jax.vjp`` of the JAX package's custom VJP,
and the port's GroupNorm32 against the JAX module.

Tolerances: fp32 1e-5 (same formula, summation order differs), 1e-6 for
the VJP's gx (elementwise, the same operations); bf16 one bf16 ulp of the
output (both compute in fp32 and round once, so at most a rounding-boundary
flip apart); the VJP's ga and gb 1e-5 of the sum of the terms' magnitudes
(summation order).
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
    gradients of the JAX package's custom VJP (on the card its backward is
    the VJP kernel: tests/test_torch_cuda.py)."""
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


def _vjp_case(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    a = rng.standard_normal((shape[0], shape[-1])).astype(np.float32)
    b = rng.standard_normal((shape[0], shape[-1])).astype(np.float32)
    jx, jg = (jnp.asarray(v, dtype=getattr(jnp, dtype)) for v in (x, g))
    return jx, jg, jnp.asarray(a), jnp.asarray(b)


def _sum_tol(x, g, a, b):
    """1e-5 of Σ|du·x| and Σ|du| (the bound on a reordered fp32 sum)."""
    _, ga_abs, gb_abs = ec.affine_silu_bwd_plain(x.abs(), g.abs(), a.abs(), b.abs())
    return 1e-5 * ga_abs.numpy() + 1e-30, 1e-5 * gb_abs.numpy() + 1e-30


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("via", ["plain", "autograd"])
def test_affine_silu_vjp_matches_jax(dtype, via):
    """affine_silu_bwd_plain, and backward() through the autograd Function,
    against jax.vjp of the JAX package's affine_silu (its custom VJP; the
    Pallas forward in interpret mode), batch 1 channels-last as the JAX
    kernel takes it: gx atol 1e-6 in fp32 and one bf16 ulp in bf16, ga and
    gb within 1e-5 of the sum of the terms' magnitudes."""
    jx, jg, ja, jb = _vjp_case(21, (1, 8, 8, 4, 64), dtype)
    assert ep.supported(jx.shape)
    _, vjp = jax.vjp(ep.affine_silu, jx, ja, jb)
    rgx, rga, rgb = (np.asarray(v, np.float32) for v in vjp(jg))
    tdt = getattr(torch, dtype)
    x = _ncdhw(np.asarray(jx, np.float32), tdt)
    g = _ncdhw(np.asarray(jg, np.float32), tdt)
    a, b = torch.from_numpy(np.array(ja)), torch.from_numpy(np.array(jb))
    if via == "plain":
        gx, ga, gb = ec.affine_silu_bwd_plain(x, g, a, b)
    else:
        x, a, b = (v.clone().requires_grad_() for v in (x, a, b))
        before = ec.affine_silu_bwd.launches
        (ec.affine_silu(x, a, b).float() * g.float()).sum().backward()
        assert ec.affine_silu_bwd.launches == before  # the CPU path launches nothing
        gx, ga, gb = x.grad, a.grad, b.grad
        x, a, b = x.detach(), a.detach(), b.detach()
    assert gx.dtype == tdt and ga.dtype == gb.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_last(gx), rgx, atol=1e-6)
    else:
        _assert_within_bf16_ulp(_last(gx), rgx)
    ta, tb = _sum_tol(x, g, a, b)
    assert np.all(np.abs(ga.numpy() - rga) <= ta)
    assert np.all(np.abs(gb.numpy() - rgb) <= tb)


def test_affine_silu_vjp_any_batch_and_both_memory_formats():
    """B = 2 in contiguous and channels_last_3d memory against the JAX
    package's VJP formula on its reference path (B > 1 takes XLA there)."""
    jx, jg, ja, jb = _vjp_case(22, (2, 4, 6, 4, 24), "float32")
    ref = [np.asarray(v) for v in ep._affine_silu_bwd((jx, ja, jb), jg)]
    for t in (_ncdhw(np.asarray(jx)), _ncdhw(np.asarray(jx)).contiguous()):
        gx, ga, gb = ec.affine_silu_bwd(t, _ncdhw(np.asarray(jg)), torch.from_numpy(np.array(ja)),
                                        torch.from_numpy(np.array(jb)))
        np.testing.assert_allclose(_last(gx), ref[0], atol=1e-6)
        np.testing.assert_allclose(ga.numpy(), ref[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gb.numpy(), ref[2], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ec.affine_silu_bwd(t, t[:, :, :2], torch.ones(2, 24), torch.zeros(2, 24))


@pytest.mark.parametrize("c,spatial,channels_last,dtype,vec", [
    (64, (112, 112, 80), True, torch.bfloat16, 8),
    (192, (8, 8, 6), True, torch.bfloat16, 8),
    (64, (112, 112, 80), False, torch.float32, 4),
    (3, (5, 3, 3), True, torch.bfloat16, 1),
    (512, (7, 7, 5), False, torch.float32, 1),
])
def test_vjp_kernel_plan(c, spatial, channels_last, dtype, vec):
    """The VJP kernel's launch plan, computed on the host: 16-byte vectors
    where the layout allows them (C or the spatial size a multiple of the
    vector), and about 8 CTAs per SM without a CTA of no work."""
    x = torch.empty((1, c, *spatial), dtype=dtype, device="meta")
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    got_vec, chunks = ec.bwd_plan(x, x, x)
    assert got_vec == vec
    s = int(np.prod(spatial))
    if channels_last:
        bdx = min(c // vec, 256)
        ctas = chunks * -(-(c // vec) // bdx)
        upper = -(-s // (256 // bdx))  # every CTA row has a voxel
    else:
        ctas = chunks * c
        upper = max(1, -(-(s // vec) // 256))  # every thread has a vector
    assert 1 <= chunks <= upper
    assert ctas >= 132 * 8 or chunks == upper
