"""The port's UNetModel against the executed-reference golden fixture and
against the JAX package's UNetModel on the same weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.models import UNetModel as JUNetModel
from fast_cwdm_tpu.ops import elementwise_pallas as ep
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.models.convert import state_dict_from_jax
from fast_cwdm_tpu_torch.models.unet import UNetModel
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "prod_unet_torch.npz")

# production channel config at a 16³ latent (as tests/test_prod_parity.py)
PROD_CFG = dict(
    image_size=16, in_channels=32, model_channels=64, out_channels=8,
    num_res_blocks=2, attention_resolutions=(), channel_mult=(1, 2, 2, 4, 4),
    dims=3, num_groups=32, resblock_updown=True, bottleneck_attention=False,
    resample_2d=False,
)
TINY_CFG = dict(
    image_size=16, in_channels=16, model_channels=32, out_channels=8,
    num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
    dims=3, num_groups=8, resblock_updown=True, bottleneck_attention=False,
    resample_2d=False,
)
# bf16: both sides round at the same points, but conv accumulation order
# and bias rounding differ and every rounding feeds the next layer. Bound the
# disagreement of two bf16 runs by twice what bf16 itself costs the
# reference against fp32 on the same input (about 1.7% of the output's
# largest value on this config, on either side).
BF16_FACTOR = 2.0


def _seeded(model: UNetModel) -> UNetModel:
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes).items()}, strict=True
    )
    return model.eval()


def test_prod_golden_forward():
    """81,511,048-parameter production UNet, fp32, against the executed
    reference (atol 5e-5), weights seeded from the torch key names."""
    data = np.load(GOLDEN)
    model = _seeded(UNetModel(**PROD_CFG))
    n = sum(p.numel() for p in model.parameters())
    assert n == int(data["__n_params__"]) == 81_511_048
    with torch.no_grad():
        y = model(torch.from_numpy(data["__x__"]), torch.from_numpy(data["__t__"]))
    np.testing.assert_allclose(y.numpy(), data["__y__"], atol=5e-5)


def _jax_pair(cfg, dtype=None, seed=0, **kw):
    """JAX model, its params and an input. The weights are seeded from the
    torch key names and carried into the flax tree by the JAX package's
    bridge (cheaper than a JAX init, and nonzero in the output convs)."""
    jmodel = JUNetModel(dtype=dtype, **cfg, **kw)
    sd = _seeded(UNetModel(**cfg)).state_dict()
    params = torch_to_flax({k: v.numpy() for k, v in sd.items()}, jmodel)
    x = np.random.default_rng(seed).standard_normal((1, 16, 16, 8, cfg["in_channels"])).astype(np.float32)
    return jmodel, params, x, np.array([7], np.int32)


def _apply(jmodel, params, x, t):
    return np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))


def _port(cfg, params, dtype=None, **kw):
    model = UNetModel(dtype=dtype, **cfg, **kw)
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model.eval()


def _run_port(model, x, t):
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(t).long())
    return y.permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("updown", [True, False])
def test_tiny_matches_jax_fp32(updown):
    cfg = dict(TINY_CFG, resblock_updown=updown)
    jmodel, params, x, t = _jax_pair(cfg)
    ref = _apply(jmodel, params, x, t)
    np.testing.assert_allclose(_run_port(_port(cfg, params), x, t), ref, atol=5e-5)


def test_tiny_matches_jax_bf16():
    jmodel, params, x, t = _jax_pair(TINY_CFG, dtype=jnp.bfloat16)
    ref = _apply(jmodel, params, x, t)
    ref32 = _apply(JUNetModel(**TINY_CFG), params, x, t)
    ours = _run_port(_port(TINY_CFG, params, dtype=torch.bfloat16), x, t)
    assert ours.dtype == np.float32
    assert np.max(np.abs(ours - ref)) <= BF16_FACTOR * np.max(np.abs(ref - ref32))


def test_fuse_gn_silu_matches_jax_fused(monkeypatch):
    """fuse_gn_silu on both sides (the JAX side runs its Pallas kernel in
    interpret mode, the port the plain version of K3)."""
    monkeypatch.setattr(ep, "INTERPRET", True)
    cfg = dict(TINY_CFG, in_channels=32, model_channels=64, num_groups=32)
    jmodel, params, x, t = _jax_pair(cfg, fuse_gn_silu=True)
    ref = _apply(jmodel, params, x, t)
    np.testing.assert_allclose(
        _run_port(_port(cfg, params, fuse_gn_silu=True), x, t), ref, atol=5e-5
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fuse_gn_silu_true_vs_false(dtype):
    """The flag changes where bf16 rounds (fp32 SiLU and one cast when
    fused), never the math: fp32 agrees to 2e-5, bf16 within BF16_FACTOR
    times the bf16-vs-fp32 error of the unfused model."""
    torch.manual_seed(0)
    base = _seeded(UNetModel(dtype=dtype, **TINY_CFG))
    fused = UNetModel(dtype=dtype, fuse_gn_silu=True, **TINY_CFG).eval()
    fused.load_state_dict(base.state_dict())
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 8, 16)).astype(np.float32)
    t = np.array([5], np.int64)
    y0, y1 = _run_port(base, x, t), _run_port(fused, x, t)
    if dtype == torch.float32:
        np.testing.assert_allclose(y1, y0, atol=2e-5)
    else:
        fp32 = UNetModel(**TINY_CFG).eval()
        fp32.load_state_dict(base.state_dict())
        y32 = _run_port(fp32, x, t)
        assert np.max(np.abs(y1 - y0)) <= BF16_FACTOR * np.max(np.abs(y0 - y32))


def test_state_dict_from_jax_inverts_the_bridge():
    """The port's layout walk is the inverse of the JAX bridge's import."""
    for updown in (True, False):
        cfg = dict(TINY_CFG, resblock_updown=updown)
        model = _seeded(UNetModel(**cfg))
        params = torch_to_flax({k: v.numpy() for k, v in model.state_dict().items()},
                               JUNetModel(**cfg))
        back = state_dict_from_jax(params, model)
        assert back.keys() == model.state_dict().keys()
        for k, v in model.state_dict().items():
            assert torch.equal(back[k], v), k


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="K4"):
        UNetModel(fuse_conv=True, **TINY_CFG)
    with pytest.raises(NotImplementedError, match="AttentionBlock"):
        UNetModel(**dict(TINY_CFG, attention_resolutions=(2,)))
