"""The port's WavUNetModel and its blocks against the executed-reference
golden fixture and against the JAX package on the same weights; its
reference weight layout (aliased decoder keys); and training and sampling
a WavUNet through the CLIs on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_cwdm_tpu.models import wunet as jwunet
from fast_cwdm_tpu.training.bridge import torch_to_flax
from fast_cwdm_tpu_torch.cli import sample
from fast_cwdm_tpu_torch.cli import train as cli_train
from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, load, save
from fast_cwdm_tpu_torch.models import convert, wunet
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "wunet_tiny_torch.npz")
# the golden's config (tests/test_bridge.py): constant width, the only one
# the reference's decoder double run executes at one res block a level
WUNET_TINY_CFG = dict(
    image_size=16, in_channels=8, model_channels=16, out_channels=8, num_res_blocks=1,
    attention_resolutions=(), channel_mult=(1, 1), dims=3, num_groups=8,
    resblock_updown=True, bottleneck_attention=False, resample_2d=False, use_freq=True,
    progressive_input="residual",
)
# widths that change between levels, two res blocks a level (so that the
# double run meets its own width), attention at ds 2 and in the bottleneck
WIDE_CFG = dict(WUNET_TINY_CFG, image_size=8, channel_mult=(1, 2), num_res_blocks=2,
                attention_resolutions=(2,), bottleneck_attention=True, num_heads=2)


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    return data, {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


def _seeded(model):
    """Seeded weights keyed by the torch names; a shared tensor takes the
    value of its last key."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes).items()},
                          strict=True)
    return model.eval()


def _apply(jmodel, params, *args, **kw):
    fn = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, **kw))
    return np.asarray(fn(params, *map(jnp.asarray, args)))


def _ours(model, x, *args, **kw):
    with torch.no_grad():
        y = model(torch.from_numpy(x).movedim(-1, 1), *args, **kw)
    return y.movedim(1, -1).numpy()


def test_golden_loads_strict_and_matches_with_ref_compat(golden):
    data, sd = golden
    model = wunet.WavUNetModel(**WUNET_TINY_CFG, ref_compat=True).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        y = model(torch.from_numpy(data["__x__"]), torch.from_numpy(data["__t__"]))
    np.testing.assert_allclose(y.numpy(), data["__y__"], atol=2e-5)


def test_round_trip_bit_for_bit_with_aliases(golden):
    """The port's state_dict has the reference's keys, aliases included;
    convert reproduces them from the JAX bridge's import bit for bit, and
    its import of them is the bridge's tree."""
    _, sd = golden
    model = wunet.WavUNetModel(**WUNET_TINY_CFG)
    params = torch_to_flax(sd, jwunet.WavUNetModel(**WUNET_TINY_CFG))
    back = convert.state_dict_from_jax(params, model)
    assert back.keys() == sd.keys() == model.state_dict().keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    ours = jax.tree_util.tree_leaves_with_path(convert.jax_params_from_state_dict(sd, model))
    ref = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        assert a.tobytes() == np.asarray(b).tobytes()
    # the shared modules: one parameter, two keys
    assert model.output_blocks[1][0] is model.output_blocks[0][0]
    assert len(dict(model.named_parameters())) < len(model.state_dict())


def test_named_parameters_convert_without_the_alias_keys(golden):
    """The train loop's parameter dict lists a shared tensor once; its JAX
    tree is the whole one."""
    _, sd = golden
    model = wunet.WavUNetModel(**WUNET_TINY_CFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    a = convert.jax_params_from_state_dict(dict(model.named_parameters()), model)
    b = convert.jax_params_from_state_dict(sd, model)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    assert all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


@pytest.mark.parametrize("over", [
    dict(ref_compat=True),
    dict(ref_compat=False),
    dict(ref_compat=True, num_classes=2, use_new_attention_order=True),
], ids=["ref_compat", "plain", "class_cond"])
def test_matches_jax_fp32(over):
    model = _seeded(wunet.WavUNetModel(**WIDE_CFG, **over))
    params = convert.jax_params_from_state_dict(model.state_dict(), model)
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 8, 8)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    y = np.array([0, 1]) if over.get("num_classes") else None
    args = (x, t) if y is None else (x, t, y)
    ref = _apply(jwunet.WavUNetModel(**WIDE_CFG, **over), params, *args)
    ours = _ours(model, x, torch.from_numpy(t).long(),
                 *(() if y is None else (torch.from_numpy(y),)))
    np.testing.assert_allclose(ours, ref, atol=5e-5)


def test_blocks_match_jax():
    """wav_down/wav_up, SkipConv (7 groups), WaveletDownsample and the
    down and up WavResBlocks, each alone."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 8, 8)).astype(np.float32)
    tx = torch.from_numpy(x).movedim(-1, 1)
    lll, highs = wunet.wav_down(tx)
    jl, jh = jwunet.wav_down(jnp.asarray(x))
    np.testing.assert_allclose(lll.movedim(1, -1).numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(highs.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(wunet.wav_up(lll, highs).movedim(1, -1).numpy(),
                               np.asarray(jwunet.wav_up(jl, jh)), atol=1e-6)

    def conv_params(conv):
        w = conv.weight.detach().numpy()
        return {"kernel": w.transpose(*range(2, w.ndim), 1, 0), "bias": conv.bias.detach().numpy()}

    skip = _seeded(wunet.SkipConv(8, 16))
    np.testing.assert_allclose(skip(highs).detach().numpy(),
                               _apply(jwunet.SkipConv(8, 16), {"conv": conv_params(skip.conv)},
                                      highs.numpy()), atol=5e-6)
    pyr = _seeded(wunet.WaveletDownsample(8, 16))
    np.testing.assert_allclose(_ours(pyr, x), _apply(jwunet.WaveletDownsample(16),
                                                     {"conv": conv_params(pyr.conv)}, x),
                               atol=5e-6)

    emb = rng.standard_normal((2, 32)).astype(np.float32)
    for kw in (dict(down=True), dict(up=True)):
        block = _seeded(wunet.WavResBlock(8, 32, out_channels=8, num_groups=4, **kw))
        sd = {k: v.numpy() for k, v in block.state_dict().items()}
        norm = lambda p: {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}  # noqa: E731
        params = {"in_norm": norm("in_layers.0"), "out_norm": norm("out_layers.0"),
                  "in_conv": conv_params(block.in_layers[2]),
                  "out_conv": conv_params(block.out_layers[3]),
                  "emb_proj": {"kernel": sd["emb_layers.1.weight"].T,
                               "bias": sd["emb_layers.1.bias"]}}
        jblock = jwunet.WavResBlock(8, 32, out_channels=8, num_groups=4, **kw)
        h = lll.movedim(1, -1).numpy() if kw.get("up") else x
        jh_in = (jnp.asarray(h), jnp.asarray(emb), jh if kw.get("up") else None)
        ref, ref_skip = jax.jit(lambda p, *a: jblock.apply({"params": p}, *a))(params, *jh_in)
        with torch.no_grad():
            ours, ours_skip = block(torch.from_numpy(h).movedim(-1, 1), torch.from_numpy(emb),
                                    highs if kw.get("up") else None)
        np.testing.assert_allclose(ours.movedim(1, -1).numpy(), np.asarray(ref), atol=5e-6)
        if kw.get("down"):
            np.testing.assert_allclose(ours_skip.numpy(), np.asarray(ref_skip), atol=5e-6)


def test_use_checkpoint_recomputes_every_block_with_the_same_gradients():
    model = _seeded(wunet.WavUNetModel(**WIDE_CFG, ref_compat=True))
    remat = _seeded(wunet.WavUNetModel(**WIDE_CFG, ref_compat=True, use_checkpoint=True))
    blocks = [m for m in remat.modules() if isinstance(m, wunet.WavResBlock)]
    assert blocks and all(b.remat for b in blocks)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 8, 8, 8, 8))
                         .astype(np.float32)).movedim(-1, 1)
    grads = []
    for m in (model, remat):
        m.zero_grad()
        (m(x, torch.tensor([5])) ** 2).mean().backward()
        grads.append({k: p.grad.clone() for k, p in m.named_parameters()})
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, atol=1e-6, rtol=1e-5)


def test_optimizer_state_round_trips_by_parameter_name(golden):
    """AdamW's moments go to optax's tree and back keyed by the parameter
    names: the alias keys of the shared decoder tensors name no moment."""
    from fast_cwdm_tpu_torch.training import state, train

    _, sd = golden
    model = wunet.WavUNetModel(**WUNET_TINY_CFG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    opt = train.make_optimizer(1e-4, lr_anneal_steps=10)
    st = state.TrainState.create(model, opt)
    for i, v in enumerate(st.opt_state["mu"].values()):
        v.fill_(i)
    back = opt.state_from_tree(opt.state_to_tree(st.opt_state, model), model, "cpu")
    assert back["mu"].keys() == st.opt_state["mu"].keys() == dict(model.named_parameters()).keys()
    assert all(torch.equal(back["mu"][k], v) for k, v in st.opt_state["mu"].items())


def test_reference_pt_into_a_model_without_ref_compat_warns(golden, tmp_path):
    from fast_cwdm_tpu_torch.cli import common

    _, sd = golden
    path = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.warns(UserWarning, match="ref_compat=False"):
        common.load_params(path, wunet.WavUNetModel(**WUNET_TINY_CFG))
    common.load_params(path, wunet.WavUNetModel(**WUNET_TINY_CFG, ref_compat=True))


def _make_case(case_dir, shape=(24, 24, 15), seed=0):
    os.makedirs(case_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = os.path.basename(case_dir)
    for m in ("t1n", "t1c", "t2w", "t2f"):
        vol = (rng.random(shape) * 900 + 100).astype(np.float32)
        vol[:4] = 0.0
        save(Nifti1Image(vol, np.eye(4)), os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


# run.sh's COMMON flags at a tiny width, with the WavUNet (two res blocks a
# level, so that the double run of the factory's ref_compat meets its width)
WUNET_FLAGS = ["--num_channels=16", "--num_res_blocks=2", "--channel_mult=1,2",
               "--attention_resolutions=", "--num_groups=8", "--bottleneck_attention=False",
               "--image_size=8", "--resample_2d=False", "--use_scale_shift_norm=False",
               "--mode=i2i", "--dtype=float32", "--diffusion_steps=10",
               "--sample_schedule=sampled", "--device=cpu", "--use_freq=True"]


def test_cli_train_then_sample_a_wunet_on_cpu(tmp_path, monkeypatch):
    """cli.train two steps (use_checkpoint, as run.sh) with --use_freq; the
    BEST's sidecar holds use_freq, and cli.sample rebuilds the WavUNet from
    it (a UNet would not load the file) and writes a checked volume."""
    for i in range(2):
        _make_case(str(tmp_path / "data" / f"0000{i}"), seed=i)
    monkeypatch.setenv("OPENAI_LOGDIR", str(tmp_path / "log"))
    ck = tmp_path / "ck"
    loop = cli_train.main([f"--data_dir={tmp_path / 'data'}", "--lr=1e-5", "--batch_size=1",
                           "--log_interval=1", "--save_interval=2", "--lr_anneal_steps=2",
                           "--use_checkpoint=True", f"--checkpoint_dir={ck}", "--contr=t1c",
                           "--cache_dataset=True", *WUNET_FLAGS])
    assert isinstance(loop.model, wunet.WavUNetModel) and loop.model.ref_compat
    assert loop.state.step == 2 and all(np.isfinite(r["loss"]) for r in loop.step_log)
    path, _, _ = ckpt.find_best_checkpoint(str(ck), "t1c")
    assert ckpt.load_checkpoint_config(path)["use_freq"] is True
    flags = [f for f in WUNET_FLAGS if not f.startswith("--use_freq")]
    sample.main(flags + [f"--data_dir={tmp_path / 'data'}", f"--model_path={path}",
                         "--contr=t1c", f"--output_dir={tmp_path / 'out'}"])
    out = load(str(tmp_path / "out" / "00000" / "sample.nii.gz")).get_fdata()
    assert out.shape == (8, 8, 155) and np.isfinite(out).all()
    assert out.min() >= 0.0 and out.max() <= 1.0 and out.max() > 0.0
    assert np.all(out[:, :, 15:] == 0.0)
