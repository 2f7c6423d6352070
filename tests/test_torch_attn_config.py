"""The cWDM UNet with ADM's attention (``cwdm_bench/configs/cwdm-attn-bf16.json``)
against the benchmark's plain reference (``cwdm_bench/reference/cwdm_attn.py``)
on seeded weights, and the attention route of ``ops/attention.py``: its
arithmetic through SDPA's math backend on the CPU against the einsum path,
and the dispatch predicate. The route itself runs only on the card
(``tests/test_torch_cuda.py -k attention``)."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.attention import SDPBackend

from cwdm_bench import harness
from cwdm_bench.reference import cwdm_attn
from fast_cwdm_tpu.models import factory as jfactory
from fast_cwdm_tpu_torch import ops
from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.models import convert
from fast_cwdm_tpu_torch.models.unet import AttentionBlock
from fast_cwdm_tpu_torch.ops import attention as attn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_FACTOR = 2.0  # as tests/test_torch_unet.py
CPU = torch.device("cpu")


def _config() -> dict:
    with open(os.path.join(ROOT, "cwdm_bench", "configs", "cwdm-attn-bf16.json")) as f:
        return json.load(f)


def _tiny(new_order: bool, dtype: str = "float32") -> dict:
    """The configuration's model at 32 channels, two levels, one ResBlock a
    level, on an 8³ latent (image_size 8): attention at ds 1 (512
    positions, 2 heads of 16) and ds 2 (64 positions, 4 heads), and in the
    bottleneck."""
    cfg = dict(_config()["model"])
    cfg.update(image_size=8, num_channels=32, channel_mult="1,2", num_res_blocks=1,
               attention_resolutions="8,4", num_head_channels=16,
               use_new_attention_order=new_order, dtype=dtype)
    return cfg


def _program(cfg: dict, seed: int):
    model, diffusion = common.build_model_and_diffusion(cfg)
    p = harness.draw_weights(cwdm_attn.param_shapes(cfg), seed, CPU)
    model.load_state_dict(p, strict=True)
    return model.eval(), diffusion, p


def _input(seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, 8, 8, 8, 32), generator=g), torch.tensor([7])


def test_param_shapes_are_the_models_at_production_size():
    cfg = _config()
    with torch.device("meta"):
        model, _ = common.build_model_and_diffusion(cfg["model"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = cwdm_attn.param_shapes(cfg["model"])
    assert got == want and list(got) == list(want)
    assert sum(math.prod(s) for s in got.values()) == cfg["parameters"] == 84_743_048
    heads = [m.heads for m in model.modules() if isinstance(m, AttentionBlock)]
    assert sorted(heads) == [2] * 5 + [4] * 11


@pytest.mark.parametrize("new_order", [False, True])
def test_forward_matches_the_reference_fp32(new_order):
    cfg = _tiny(new_order)
    model, _, p = _program(cfg, 3)
    assert sum(isinstance(m, AttentionBlock) for m in model.modules()) == 7
    x, t = _input(1)
    with torch.no_grad():
        want = cwdm_attn.unet(p, cfg, x, t)
        got = model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)
    assert float(want.abs().mean()) > 0.1  # the seeded weights give a non-trivial output


@pytest.mark.parametrize("new_order", [False, True])
def test_forward_bf16_is_within_the_bf16_factor(new_order):
    """The program in bf16 against the reference in fp32: within
    BF16_FACTOR times what bf16 costs the JAX package's model against fp32,
    on the same weights."""
    cfg = _tiny(new_order, "bfloat16")
    model, _, p = _program(cfg, 4)
    x, t = _input(2)
    with torch.no_grad():
        ref = cwdm_attn.unet(p, cfg, x, t).numpy()
        ours = model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1).numpy()
    params = convert.jax_params_from_state_dict(model.state_dict(), model)
    costs = []
    for dtype in ("bfloat16", "float32"):
        jmodel, _ = jfactory.create_model_and_diffusion(**dict(cfg, dtype=dtype))
        fn = jax.jit(lambda q, a, b: jmodel.apply({"params": q}, a, b))
        costs.append(np.asarray(fn(params, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()))))
    bf16_cost = np.max(np.abs(costs[0] - costs[1]))
    assert 0 < np.max(np.abs(ours - ref)) <= BF16_FACTOR * bf16_cost


def test_two_step_synthesis_matches_the_reference():
    from cwdm_bench import phantom

    cfg = dict(_tiny(False), diffusion_steps=2)
    model, diffusion, p = _program(cfg, 5)
    geo = {"raw": [24, 24, 14], "crop_xy": 4, "pad_z": 16, "crop_z": 14}
    case = phantom.make_case(3, geo, CPU)
    g = torch.Generator().manual_seed(2)
    x_t = torch.randn((1, 8, 8, 8, 8), generator=g)
    steps = torch.randn((2, 1, 8, 8, 8, 8), generator=g)
    run = common.make_synthesis_fn(model, diffusion, device="cpu", crop_z=14)
    cond = common.prepare_condition({m: case[m].numpy() for m in case}, "t1c", device="cpu")
    want = torch.as_tensor(run(cond, case["t1n"].numpy(), noise=x_t, step_noise=steps))
    got = cwdm_attn.synthesize(p, cfg, case, case["t1n"], x_t, steps, "t1c", 14)
    assert got.shape == want.shape == (1, 16, 16, 14)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)
    inside = case["t1n"][..., 0][..., :14] != 0
    assert 0.05 < float(want[inside].std())


@pytest.mark.parametrize("shape", [(2, 37, 3, 16), (1, 300, 2, 64)])
def test_fused_route_layout_and_scaling_through_the_math_backend(shape):
    """``attention.sdpa`` (the fused route's views, scaling and call, here
    on SDPA's math backend in fp32) against the einsum path."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g) for _ in range(3))
    scale = 1.0 / math.sqrt(math.sqrt(shape[-1]))
    got = attn.sdpa(q, k, v, scale, SDPBackend.MATH)
    torch.testing.assert_close(got, attn.plain(q, k, v, scale), rtol=0, atol=1e-5)
    assert got.shape == shape


def test_the_block_on_the_math_backend_equals_the_einsum_path(monkeypatch):
    """An AttentionBlock with its fused route taken and SDPA held to the math
    backend gives the einsum path's output: the route's head split and
    merge are the block's."""
    block = AttentionBlock(64, num_head_channels=16, num_groups=8).eval()
    g = torch.Generator().manual_seed(1)
    for prm in block.parameters():
        torch.nn.init.normal_(prm, std=0.2, generator=g)
    x = torch.randn((2, 64, 4, 5, 3), generator=torch.Generator().manual_seed(2))
    real = attn.sdpa
    with torch.no_grad():
        want = block(x)
        monkeypatch.setattr(attn, "fused_ok", lambda q: True)
        monkeypatch.setattr(attn, "sdpa", lambda q, k, v, s: real(q, k, v, s, SDPBackend.MATH))
        got = block(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.fixture
def on_card(monkeypatch):
    """Every tensor reads as a CUDA tensor, the predicate's first condition."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def _q(dtype=torch.bfloat16, ch=64, grad=False):
    return torch.zeros((1, 8, 2, ch), dtype=dtype, requires_grad=grad)


def test_the_predicate_takes_bf16_and_fp16_outside_autograd(on_card, monkeypatch):
    assert attn.fused_ok(_q()) and attn.fused_ok(_q(torch.float16))
    assert not attn.fused_ok(_q(torch.float32))
    assert not attn.fused_ok(_q(ch=12)) and not attn.fused_ok(_q(ch=512))
    with torch.enable_grad():
        assert not attn.fused_ok(_q(grad=True))
    with torch.no_grad():
        assert attn.fused_ok(_q(grad=True))
    monkeypatch.setattr(attn, "current_sp", lambda: object())
    assert not attn.fused_ok(_q())


def test_the_predicate_keeps_cpu_tensors_on_the_einsum_path():
    assert not attn.fused_ok(_q()) and not attn.fused_ok(_q(torch.float16))


def test_the_counter_does_not_move_off_the_route():
    cfg = _tiny(False, "bfloat16")
    model, _, _ = _program(cfg, 6)
    x, t = _input(3)
    before = ops.launch_counts()
    with torch.no_grad():
        model(x.permute(0, 4, 1, 2, 3), t)
    assert "attention" in before and ops.launches_since(before) == {}
