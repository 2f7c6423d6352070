"""The port's network surface beyond the production UNet: AttentionBlock,
class conditioning, dims 1-2, SuperResModel, EncoderUNetModel and the
classifier factory, the wavelet-gated blocks and the 1-D/2-D wavelets,
against the reference golden fixtures and against the JAX package on the
same weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.models import factory as jfactory
from fast_cwdm_tpu.models import unet as junet
from fast_cwdm_tpu.ops import wavelet as jwv
from fast_cwdm_tpu.training.bridge import flax_to_torch, torch_to_flax
from fast_cwdm_tpu_torch import ops
from fast_cwdm_tpu_torch.cli import common, sample
from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, load, save
from fast_cwdm_tpu_torch.models import convert, factory
from fast_cwdm_tpu_torch.models import unet
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BF16_FACTOR = 2.0  # as tests/test_torch_unet.py

# the golden fixtures' configs (tests/test_bridge.py)
UNET_GOLDEN_CFG = dict(
    image_size=16, in_channels=8, model_channels=16, out_channels=8, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), dims=3, num_groups=8,
    resblock_updown=True, bottleneck_attention=True, resample_2d=False, num_heads=2,
)
ENCODER_GOLDEN_CFG = dict(
    image_size=16, in_channels=8, model_channels=16, out_channels=5, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), dims=2, num_groups=8,
    resblock_updown=True, pool="adaptive", resample_2d=True, num_heads=2,
)
# attention at ds 2 (4³ = 64 positions of an 8³ input) and in the bottleneck
ATTN_CFG = dict(UNET_GOLDEN_CFG, image_size=8)


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    return data, {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


def _seeded(model):
    """Seeded weights keyed by the torch names (tests/test_torch_unet.py)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes).items()},
                          strict=True)
    return model.eval()


def _jax(model):
    """The port model's weights as the JAX package's params tree."""
    return convert.jax_params_from_state_dict(model.state_dict(), model)


def _apply(jmodel, params, *args, **kw):
    fn = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, **kw))
    return np.asarray(fn(params, *map(jnp.asarray, args)))


def _ours(model, x, *args, **kw):
    """The port's forward on channels-last numpy ``x``, channels-last out."""
    with torch.no_grad():
        y = model(torch.from_numpy(x).movedim(-1, 1), *args, **kw)
    return (y.movedim(1, -1) if y.dim() > 2 else y).numpy()


def _t(*v):
    return np.array(v, np.int32)


# ---------------------------------------------------------------------------
# Goldens: the executed reference's outputs on its own weights
# ---------------------------------------------------------------------------


def test_unet_golden_loads_strict_and_matches():
    """Legacy head order, attention in the encoder, bottleneck and decoder."""
    data, sd = _golden("unet_tiny_torch")
    model = unet.UNetModel(**UNET_GOLDEN_CFG).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(data["__x__"]), torch.from_numpy(data["__t__"]))
    np.testing.assert_allclose(y.numpy(), data["__y__"], atol=1e-5)


def test_encoder_golden_loads_strict_and_matches():
    data, sd = _golden("encoder_tiny_torch")
    model = unet.EncoderUNetModel(**ENCODER_GOLDEN_CFG).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(data["__x__"]), torch.from_numpy(data["__t__"]))
    np.testing.assert_allclose(y.numpy(), data["__y__"], atol=1e-5)


@pytest.mark.parametrize("name,jcls,cls,cfg", [
    ("unet_tiny_torch", junet.UNetModel, unet.UNetModel, UNET_GOLDEN_CFG),
    ("encoder_tiny_torch", junet.EncoderUNetModel, unet.EncoderUNetModel, ENCODER_GOLDEN_CFG),
])
def test_convert_round_trips_the_goldens_bit_for_bit(name, jcls, cls, cfg):
    """state_dict_from_jax of the JAX bridge's import is the golden
    state_dict; jax_params_from_state_dict of it is the bridge's tree."""
    _, sd = _golden(name)
    params = torch_to_flax(sd, jcls(**cfg))
    model = cls(**cfg)
    back = convert.state_dict_from_jax(params, model)
    assert back.keys() == sd.keys() == model.state_dict().keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    ours = jax.tree_util.tree_leaves_with_path(convert.jax_params_from_state_dict(sd, model))
    ref = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()


# ---------------------------------------------------------------------------
# UNetModel: attention, class conditioning, dims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [
    {},  # legacy head order
    dict(use_new_attention_order=True),
    dict(num_head_channels=8, num_heads_upsample=1),
    dict(num_classes=2),
    dict(dims=2, attention_resolutions=(2, 4), resblock_updown=False),
    dict(dims=1, resample_2d=True),
], ids=["legacy", "new_order", "head_channels", "class_cond", "dims2", "dims1"])
def test_unet_matches_jax_fp32(over):
    cfg = dict(ATTN_CFG, **over)
    model = _seeded(unet.UNetModel(**cfg))
    x = np.random.default_rng(0).standard_normal(
        (2, *(8,) * cfg["dims"], cfg["in_channels"])).astype(np.float32)
    t = _t(7, 300)
    kw = {"y": np.array([1, 0])} if cfg.get("num_classes") else {}
    ref = _apply(junet.UNetModel(**cfg), _jax(model), x, t, *kw.values())
    ours = _ours(model, x, torch.from_numpy(t).long(),
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(ours, ref, atol=5e-5)


@pytest.mark.parametrize("new_order", [False, True])
def test_attention_unet_matches_jax_bf16(new_order):
    """Within BF16_FACTOR times what bf16 costs the JAX model against fp32."""
    cfg = dict(ATTN_CFG, use_new_attention_order=new_order)
    model = _seeded(unet.UNetModel(**cfg, dtype=torch.bfloat16))
    params = _jax(model)
    x = np.random.default_rng(1).standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    t = _t(11)
    ref = _apply(junet.UNetModel(**cfg, dtype=jnp.bfloat16), params, x, t)
    ref32 = _apply(junet.UNetModel(**cfg), params, x, t)
    ours = _ours(model, x, torch.from_numpy(t).long())
    assert ours.dtype == np.float32
    assert np.max(np.abs(ours - ref)) <= BF16_FACTOR * np.max(np.abs(ref - ref32))


def test_attention_block_matches_jax():
    """The block alone, both head orders, on a bf16 input with fp32 params:
    flax promotes to fp32, as the port's dtype rule."""
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 5, 32)).astype(np.float32)
    for new_order in (False, True):
        block = _seeded(unet.AttentionBlock(32, 4, -1, new_order, num_groups=8))
        sd = {k: v.numpy() for k, v in block.state_dict().items()}
        params = {"norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
                  **{n: {"kernel": sd[f"{n}.weight"][:, :, 0].T, "bias": sd[f"{n}.bias"]}
                     for n in ("qkv", "proj_out")}}
        jblock = junet.AttentionBlock(32, 4, -1, new_order, num_groups=8)
        np.testing.assert_allclose(_ours(block, x), _apply(jblock, params, x), atol=5e-6)


def test_class_labels_must_match_num_classes():
    model = _seeded(unet.UNetModel(**dict(ATTN_CFG, num_classes=2)))
    x = torch.zeros((1, 8, 8, 8, 8))
    with pytest.raises(ValueError, match="class labels"):
        model(x, torch.tensor([1]))
    with pytest.raises(ValueError, match="class labels"):
        unet.UNetModel(**ATTN_CFG)(x, torch.tensor([1]), torch.tensor([0]))


# ---------------------------------------------------------------------------
# SuperResModel, EncoderUNetModel and the factories
# ---------------------------------------------------------------------------

SR_CFG = dict(
    image_size=16, in_channels=6, model_channels=16, out_channels=3, num_res_blocks=1,
    attention_resolutions=(2,), channel_mult=(1, 2), dims=2, num_groups=8,
    resblock_updown=True, num_heads=2,
)


def test_bilinear_upsample_matches_jax_image_resize():
    """resize_linear against jax.image.resize(bilinear) at ×2 and ×4
    upscales, tolerance 1e-6."""
    low = np.random.default_rng(3).standard_normal((2, 5, 7, 3)).astype(np.float32)
    for size in ((10, 14), (20, 28)):
        ref = np.asarray(jax.image.resize(jnp.asarray(low), (2, *size, 3), "bilinear"))
        ours = unet.resize_linear(torch.from_numpy(low).movedim(-1, 1), size)
        np.testing.assert_allclose(ours.movedim(1, -1).numpy(), ref, atol=1e-6)


# (input spatial, output spatial): the four downscales of the fault where
# F.interpolate missed jax.image.resize by 0.60-0.88, a 1-D case, and
# mixed shrink/grow sizes in each dimension count
RESIZE_CASES = [
    ((16, 16), (8, 8)),
    ((16, 16), (12, 20)),
    ((8, 8, 8), (4, 4, 4)),
    ((8, 8, 8), (8, 8, 4)),
    ((12,), (5,)),
    ((7,), (16,)),
    ((9, 6), (4, 13)),
    ((6, 9, 5), (11, 4, 5)),
]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_linear_matches_jax_image_resize(src, dst):
    """Downscales antialias as jax.image.resize does (the triangle kernel
    widened by 1/scale), mixed shrink/grow sizes, dims 1-3; tolerance
    1e-6."""
    x = np.random.default_rng(0).standard_normal((1, *src, 2)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 2), "bilinear"))
    ours = unet.resize_linear(torch.from_numpy(x).movedim(-1, 1), dst)
    np.testing.assert_allclose(ours.movedim(1, -1).numpy(), ref, atol=1e-6)


def test_super_res_model_matches_jax():
    model = _seeded(unet.SuperResModel(**SR_CFG))
    params = convert.jax_params_from_state_dict(model.state_dict(), model)
    assert set(params) == {"unet"}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = _t(3, 900)
    ref = _apply(junet.SuperResModel(unet=junet.UNetModel(**SR_CFG)), params, x, t,
                 low_res=jnp.asarray(low))
    ours = _ours(model, x, torch.from_numpy(t).long(),
                 low_res=torch.from_numpy(low).movedim(-1, 1))
    np.testing.assert_allclose(ours, ref, atol=5e-5)


@pytest.mark.parametrize("dims,low_size", [(1, (24,)), (2, (32, 12)), (3, (16, 8, 12))])
def test_super_res_model_with_a_shrinking_low_res_matches_jax(dims, low_size):
    """low_res larger than x on some axis: the antialiased downscale
    inside the forward, in dims 1-3; fp32, atol 5e-5."""
    cfg = dict(SR_CFG, dims=dims, image_size=8 if dims == 3 else 16,
               attention_resolutions=() if dims == 3 else (2,))
    model = _seeded(unet.SuperResModel(**cfg))
    params = convert.jax_params_from_state_dict(model.state_dict(), model)
    rng = np.random.default_rng(5)
    spatial = (cfg["image_size"],) * dims
    x = rng.standard_normal((1, *spatial, 3)).astype(np.float32)
    low = rng.standard_normal((1, *low_size, 3)).astype(np.float32)
    t = _t(7)
    ref = _apply(junet.SuperResModel(unet=junet.UNetModel(**cfg)), params, x, t,
                 low_res=jnp.asarray(low))
    ours = _ours(model, x, torch.from_numpy(t).long(),
                 low_res=torch.from_numpy(low).movedim(-1, 1))
    np.testing.assert_allclose(ours, ref, atol=5e-5)


def _encoder_params(model, cfg):
    """JAX params of an EncoderUNetModel of any pool (built from ``cfg``):
    the trunk through convert (on an adaptive twin: the spatial heads have
    no reference layout), the spatial heads by hand."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if model.pool == "adaptive":
        return convert.jax_params_from_state_dict(sd, model)
    twin = unet.EncoderUNetModel(**dict(cfg, pool="adaptive"))
    trunk = {k: v for k, v in twin.state_dict().items() if k.startswith("out.")}
    trunk.update({k: v for k, v in sd.items() if not k.startswith("out.")})
    params = convert.jax_params_from_state_dict(trunk, twin)
    del params["out_norm"], params["out_conv"]
    dense = lambda i: {"kernel": sd[f"out.{i}.weight"].T, "bias": sd[f"out.{i}.bias"]}  # noqa: E731
    if model.pool == "spatial":
        params["out_dense"] = dense(0)
    else:
        params.update(out_dense0=dense(0), out_dense1=dense(3),
                      out_norm={"scale": sd["out.1.weight"], "bias": sd["out.1.bias"]})
    return params


@pytest.mark.parametrize("pool", ["adaptive", "spatial", "spatial_v2"])
def test_encoder_matches_jax(pool):
    cfg = dict(ENCODER_GOLDEN_CFG, pool=pool)
    model = _seeded(unet.EncoderUNetModel(**cfg))
    x = np.random.default_rng(5).standard_normal((2, 16, 16, 8)).astype(np.float32)
    t = _t(5, 600)
    ref = _apply(junet.EncoderUNetModel(**cfg), _encoder_params(model, cfg), x, t)
    ours = _ours(model, x, torch.from_numpy(t).long())
    assert ours.shape == (2, 5) and np.abs(ours).max() > 0
    np.testing.assert_allclose(ours, ref, atol=5e-5)


CLASSIFIER = dict(
    image_size=16, classifier_width=16, classifier_depth=1,
    classifier_attention_resolutions="8", classifier_num_head_channels=8,
    classifier_channel_mult="1,2", dims=2, num_groups=8, in_channels=3,
)


@pytest.mark.parametrize("pool", ["spatial", "adaptive"])
def test_create_classifier_matches_jax(pool):
    cfg = dict(CLASSIFIER, classifier_pool=pool)
    ours, diffusion = factory.create_classifier_and_diffusion(**cfg)
    ref_model, ref_diffusion = jfactory.create_classifier_and_diffusion(**cfg)
    assert diffusion.num_timesteps == ref_diffusion.num_timesteps == 1000
    fields = ("model_channels", "channel_mult", "attention_resolutions", "num_res_blocks", "pool")
    assert tuple(getattr(ours, f) for f in fields) == tuple(getattr(ref_model, f) for f in fields)
    built = {f: getattr(ref_model, f) for f in (
        "image_size", "in_channels", "model_channels", "out_channels", "num_res_blocks",
        "attention_resolutions", "channel_mult", "dims", "num_head_channels",
        "use_scale_shift_norm", "resblock_updown", "pool", "num_groups")}
    _seeded(ours)
    x = np.random.default_rng(6).standard_normal((1, 16, 16, 3)).astype(np.float32)
    ref = _apply(ref_model, _encoder_params(ours, built), x, _t(40))
    np.testing.assert_allclose(_ours(ours, x, torch.tensor([40])), ref, atol=5e-5)


def test_sr_create_model_and_diffusion_matches_jax():
    cfg = dict(large_size=64, num_channels=16, num_res_blocks=1, attention_resolutions="16",
               num_groups=8, num_heads=1)
    ours, diffusion = factory.sr_create_model_and_diffusion(**cfg)
    ref_model, ref_diffusion = jfactory.sr_create_model_and_diffusion(**cfg)
    assert isinstance(ours, unet.SuperResModel) and ours.dims == 2
    assert diffusion.num_timesteps == ref_diffusion.num_timesteps
    _seeded(ours)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    low = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    ref = _apply(ref_model, _jax(ours), x, _t(500), low_res=jnp.asarray(low))
    ours_y = _ours(ours, x, torch.tensor([500]), low_res=torch.from_numpy(low).movedim(-1, 1))
    np.testing.assert_allclose(ours_y, ref, atol=5e-5)


# ---------------------------------------------------------------------------
# Wavelet gating and the 1-D/2-D wavelets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("up", [False, True])
def test_wavelet_gating_blocks_match_jax(up):
    cls, jcls = ((unet.WaveletGatingUpsample, junet.WaveletGatingUpsample) if up else
                 (unet.WaveletGatingDownsample, junet.WaveletGatingDownsample))
    block = _seeded(cls(4, 8))
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    params = {f"fnn_{i}": {"kernel": sd[f"fnn.{i}.weight"].T, "bias": sd[f"fnn.{i}.bias"]}
              for i in (0, 2)}
    if up:
        params["conv_exp"] = {"kernel": sd["conv_exp.weight"].transpose(2, 3, 4, 1, 0),
                              "bias": sd["conv_exp.bias"]}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 6, 8, 4)).astype(np.float32)
    temb = rng.standard_normal((2, 8)).astype(np.float32)
    ref = _apply(jcls(4, 8), params, x, temb)
    ours = _ours(block, x, torch.from_numpy(temb))
    assert ours.shape == ((2, 8, 12, 16, 4) if up else (2, 2, 3, 4, 4))
    np.testing.assert_allclose(ours, ref, atol=5e-6)


@pytest.mark.parametrize("wavelet", ["haar", "db2"])
def test_1d_2d_wavelets_match_jax(wavelet):
    x = np.random.default_rng(9).standard_normal((2, 8, 12, 3)).astype(np.float32)
    tx = torch.from_numpy(x)
    for ours, ref in ((ops.dwt1(tx, wavelet), jwv.dwt1(jnp.asarray(x), wavelet)),
                      (ops.dwt2(tx, wavelet), jwv.dwt2(jnp.asarray(x), wavelet)),
                      (ops.dwt2_tiny(tx, wavelet), jwv.dwt2_tiny(jnp.asarray(x), wavelet))):
        for a, b in zip(ours if isinstance(ours, tuple) else (ours,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    lo, hi = ops.dwt1(tx, wavelet)
    np.testing.assert_allclose(ops.idwt1(lo, hi, wavelet).numpy(),
                               np.asarray(jwv.idwt1(jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                                                    wavelet)), atol=1e-6)
    bands = ops.dwt2(tx, wavelet)
    np.testing.assert_allclose(ops.idwt2(bands, wavelet).numpy(),
                               np.asarray(jwv.idwt2(jnp.asarray(bands.numpy()), wavelet)), atol=1e-6)
    if wavelet == "haar":  # db2's zero-boundary truncation loses the edges
        np.testing.assert_allclose(ops.idwt2(bands, wavelet).numpy(), x, atol=1e-5)


def test_haar_rounds_its_scale_as_jax_in_bf16():
    """1/√2 meets a bf16 array as bf16(1/√2) on both sides: a 2-D Haar DWT
    of bf16 data equals the JAX package's bit for bit."""
    x = np.random.default_rng(10).standard_normal((1, 8, 8, 2)).astype(np.float32)
    ours = ops.dwt2(torch.from_numpy(x).bfloat16()).float().numpy()
    ref = np.asarray(jwv.dwt2(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# The schema's own defaults and the CLI
# ---------------------------------------------------------------------------


def test_bare_cli_flags_build_an_attention_unet():
    """cli.sample's flags with no model flag (attention "16,8", 4 heads):
    the model builds, as in the JAX package (on the meta device: its
    weights are never made)."""
    args = sample.create_argparser().parse_args([])
    cfg = factory.args_to_dict(args, factory.model_and_diffusion_defaults().keys())
    with torch.device("meta"):
        model, _ = factory.create_model_and_diffusion(**cfg)
    blocks = [m for m in model.modules() if isinstance(m, unet.AttentionBlock)]
    assert isinstance(model, unet.UNetModel) and model.attention_resolutions == (4, 8)
    # ds 4 and 8: two encoder blocks and three decoder blocks each
    assert len(blocks) == 10 and {b.heads for b in blocks} == {4}


def _make_case(case_dir, shape=(24, 24, 15), seed=0):
    """Four tiny BraTS modalities (tests/test_torch_synthesis.py)."""
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in ("t1n", "t1c", "t2w", "t2f"):
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        vol[:4] = 0.0
        save(Nifti1Image(vol, np.eye(4)), os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


def test_cli_train_then_sample_with_attention_on_cpu(tmp_path, monkeypatch):
    """cli.train two steps with attention flags (ds 2 and the bottleneck,
    2 heads), then cli.sample from its BEST with the production flags: the
    sidecar brings the attention config back (the production UNet would
    not load the file), and the volume is checked."""
    from fast_cwdm_tpu_torch.cli import train as cli_train
    from fast_cwdm_tpu_torch.training import checkpoints as ckpt

    for i in range(2):
        _make_case(str(tmp_path / "data" / f"0000{i}"), seed=i)
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path / "log"))
    tiny = dict(num_channels=16, num_res_blocks=1, channel_mult="1,2", num_groups=8,
                image_size=8, resample_2d=False, use_scale_shift_norm=False, mode="i2i",
                dtype="float32", diffusion_steps=10, sample_schedule="sampled")
    attn = dict(attention_resolutions="4", bottleneck_attention=True, num_heads=2)
    flags = [f"--{k}={v}" for k, v in {**tiny, **attn}.items()] + ["--device=cpu"]
    loop = cli_train.main([f"--data_dir={tmp_path / 'data'}", "--batch_size=1",
                           "--log_interval=1", "--save_interval=2", "--lr_anneal_steps=2",
                           f"--checkpoint_dir={tmp_path / 'ck'}", "--contr=t1c", *flags])
    assert sum(isinstance(m, unet.AttentionBlock) for m in loop.model.modules()) == 4
    assert loop.state.step == 2 and all(np.isfinite(r["loss"]) for r in loop.step_log)
    path, _, _ = ckpt.find_best_checkpoint(str(tmp_path / "ck"), "t1c")
    prod = [f"--{k}={v}" for k, v in common.production_config(**tiny).items()]
    sample.main(prod + [f"--data_dir={tmp_path / 'data'}", f"--model_path={path}",
                        "--contr=t1c", f"--output_dir={tmp_path / 'out'}", "--device=cpu"])
    out = load(str(tmp_path / "out" / "00000" / "sample.nii.gz")).get_fdata()
    assert out.shape == (8, 8, 155) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0 and out.max() > 0.0


def test_flax_to_torch_of_the_converted_tree_is_the_state_dict():
    """The JAX bridge's export of the port's JAX tree gives back the
    port's state_dict, attention and class embedding included."""
    cfg = dict(ATTN_CFG, num_classes=2)
    model = _seeded(unet.UNetModel(**cfg))
    back = flax_to_torch(_jax(model), junet.UNetModel(**cfg))
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy())
