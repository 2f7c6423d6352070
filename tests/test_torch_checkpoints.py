"""The port's checkpoint layer against the JAX package's: the msgpack codec
of ``.ckpt`` files (JAX writes, the port reads; the port writes, JAX
reads; encoder bytes equal flax's), BEST discovery, the weight maps, the
converter CLI, and ``load_best_synthesis`` images under ddpm, ddim and
dpm++."""

import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization as fser

from fast_cwdm_tpu.cli import common as jcommon
from fast_cwdm_tpu.cli import convert_checkpoint as jconvert
from fast_cwdm_tpu.training import bridge
from fast_cwdm_tpu.training import checkpoints as jckpt
from fast_cwdm_tpu_torch.cli import common, convert_checkpoint
from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict, state_dict_from_jax
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training import serialization as ser
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

TINY = dict(
    num_channels=16, num_res_blocks=1, channel_mult="1,2", attention_resolutions="",
    num_groups=8, bottleneck_attention=False, image_size=8, resample_2d=False,
    diffusion_steps=10, sample_schedule="sampled", dtype="float32",
)
MODALITIES = ("t1n", "t1c", "t2w", "t2f")


def _seeded(cfg, scale=1.0):
    """Port model with seeded weights, its state_dict (numpy) and the JAX
    model of the same config."""
    model, _ = common.build_model_and_diffusion(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = {k: scale * v for k, v in seeded_state_dict(shapes).items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jmodel, _ = jcommon.build_model_and_diffusion(
        {k: v for k, v in cfg.items() if k not in ("fuse_gn_silu", "fuse_conv")})
    return model, sd, jmodel


def _assert_same_tree(ours, ref, path=""):
    """Bit for bit: the same keys, types, dtypes, shapes and bytes."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _assert_same_tree(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(ours, torch.Tensor):  # bfloat16
        ref = np.asarray(ref)
        assert ours.dtype == torch.bfloat16 and ref.dtype.name == "bfloat16", path
        assert tuple(ours.shape) == ref.shape, path
        assert np.array_equal(ours.view(torch.int16).numpy(), ref.view(np.int16)), path
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(ours) is type(ref), (path, type(ours), type(ref))
        assert ours.dtype == ref.dtype and np.shape(ours) == np.shape(ref), path
        assert np.asarray(ours).tobytes() == np.asarray(ref).tobytes(), path
    else:
        assert type(ours) is type(ref) and ours == ref, (path, ours, ref)


def _tree(seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    tree = {"in_conv": {"kernel": rng.standard_normal((3, 3, 3, 4, 8)).astype(np.float32),
                        "bias": rng.standard_normal(8).astype(np.float32)},
            "out_norm": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}}
    if bf16:
        tree["half"] = {"kernel": np.asarray(jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16))}
    return tree


def _to_torch(tree):
    """The tree with its array leaves as torch tensors, in the same order."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(tree).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(tree)) if isinstance(tree, np.ndarray) else tree


# n_ema, step, forced chunking, a bf16 leaf
LAYOUTS = [(0, 7, False, False), (1, np.asarray(7, np.int64), False, False),
           (2, 123456, True, False), (1, 3, False, True)]


@pytest.mark.parametrize("n_ema,step,chunk,bf16", LAYOUTS)
def test_port_reads_jax_ckpt(tmp_path, monkeypatch, n_ema, step, chunk, bf16):
    """.ckpt files written by the JAX package's save_checkpoint: 0-2 EMA
    shadows, step as an int and as a 0-d array, a leaf forced into chunks,
    a bfloat16 leaf. The port decodes each bit for bit against flax."""
    if chunk:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 200)  # the 864-byte kernel splits
    params = _tree(0, bf16)
    payload = {"params": params, "ema_params": tuple(_tree(1 + i, bf16) for i in range(n_ema)),
               "step": step}
    path = str(tmp_path / "brats_t1c_BEST_sampled_10.ckpt")
    jckpt.save_checkpoint(path, payload, config={"sample_schedule": "sampled"})
    with open(path, "rb") as f:
        blob = f.read()
    if chunk:
        assert b"__msgpack_chunked_array__" in blob
    _assert_same_tree(ckpt.load_checkpoint(path), fser.msgpack_restore(blob))
    loaded = ckpt.load_with_ema_probe(path)
    ref = jckpt.load_with_ema_probe(path, jax.tree.map(np.asarray, params))
    assert len(loaded["ema_params"]) == n_ema
    _assert_same_tree(loaded["params"], ref["params"])
    _assert_same_tree(loaded["ema_params"], ref["ema_params"])
    _assert_same_tree(loaded["step"], ref["step"])
    # the JAX writer stores every leaf as an array; flax's own encoder keeps
    # a Python int
    raw = fser.to_bytes(payload)
    _assert_same_tree(ser.msgpack_restore(raw), fser.msgpack_restore(raw))


@pytest.mark.parametrize("n_ema,step,chunk,bf16", LAYOUTS)
def test_jax_reads_port_ckpt(tmp_path, monkeypatch, n_ema, step, chunk, bf16):
    """The port's save_checkpoint: JAX's load_with_ema_probe reads it bit
    for bit, and its bytes equal flax's for the same tree (torch tensors,
    bfloat16 included, encode as the arrays they hold)."""
    if chunk:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 200)
        monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 200)
    params = _tree(0, bf16)
    payload = {"params": params, "ema_params": tuple(_tree(1 + i, bf16) for i in range(n_ema)),
               "step": step}
    as_torch = _to_torch(payload)  # the same tree with torch leaves
    path = str(tmp_path / "x.ckpt")
    ckpt.save_checkpoint(path, as_torch, config={"contr": "t1c"})
    with open(path, "rb") as f:
        blob = f.read()
    # the bytes JAX's save_checkpoint writes (every leaf an array) and, for
    # the tree as it is, flax's encoder's
    assert blob == fser.to_bytes(jax.tree.map(np.asarray, payload))
    assert ser.to_bytes(payload) == fser.to_bytes(payload)
    assert ser.to_bytes(as_torch) == fser.to_bytes(payload)
    ref = jckpt.load_with_ema_probe(path, params)
    _assert_same_tree(ref["params"], params)
    _assert_same_tree(ref["ema_params"], payload["ema_params"])
    assert json.load(open(path + ".json")) == jckpt.load_checkpoint_config(path) == {"contr": "t1c"}


def test_codec_covers_every_msgpack_form():
    """Every form packb emits: fix/8/16/32 maps, arrays, strings and bins,
    signed and unsigned ints at each width's edges, float32/64, nil, bool,
    the three extension types. Decoding equals msgpack's; for the same dict
    the encoder's bytes equal packb's."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    leaves = {f"i{k}": v for k, v in enumerate(ints)}
    for n in (0, 31, 32, 255, 256, 65535, 65536):
        leaves[f"s{n}"] = "é" * (n // 2) + "x" * (n % 2)
        leaves[f"b{n}"] = bytes(n)
    leaves.update(f=1.5, nan=float("nan"), none=None, t=True, f0=False, c=3 - 4j,
                  np32=np.float32(2.5), i8=np.int8(-3), arr=np.arange(70000, dtype=np.uint8),
                  z=np.zeros((0, 3), np.float64), b=np.asarray([True, False]))
    tree = {"leaves": leaves, "m15": {str(i): i for i in range(15)},
            "m16": {str(i): i for i in range(16)}, "m65536": {str(i): 0 for i in range(65536)}}
    packed = msgpack.packb(tree, default=fser._msgpack_ext_pack, strict_types=True)
    assert ser.to_bytes(tree) == packed
    ours, ref = ser.msgpack_restore(packed), fser.msgpack_restore(packed)
    assert np.isnan(ours["leaves"].pop("nan")) and np.isnan(ref["leaves"].pop("nan"))
    _assert_same_tree(ours, ref)
    # arrays (never emitted at the top level by flax), float32, raw bins
    for v in ([], list(range(15)), list(range(16)), list(range(70000)), [[1, [2.0, None]]]):
        assert ser.msgpack_restore(msgpack.packb(v)) == msgpack.unpackb(msgpack.packb(v))
    assert ser.msgpack_restore(msgpack.packb(1.25, use_single_float=True)) == 1.25
    with pytest.raises(ValueError, match="extension"):
        ser.msgpack_restore(msgpack.packb(msgpack.ExtType(9, b"x")))
    with pytest.raises(ValueError, match="extra data"):
        ser.msgpack_restore(packed + b"\x00")


def test_bad_files_raise_as_in_jax(tmp_path):
    """A truncated or corrupt file, or one of another layout, gives the
    ValueError JAX gives; a missing file raises FileNotFoundError; the
    same holds for an .orbax directory, whose round trip loads."""
    params = _tree()
    good = str(tmp_path / "good.ckpt")
    jckpt.save_checkpoint(good, {"params": params, "ema_params": (params,), "step": 1})
    blob = open(good, "rb").read()
    bad = {"truncated.ckpt": blob[: len(blob) // 2], "garbage.ckpt": b"\xc1" + blob,
           "layout.ckpt": fser.to_bytes({"params": params, "step": 1}),
           "dtype.ckpt": blob.replace(b"float32", b"floatXX")}
    for name, data in bad.items():
        path = str(tmp_path / name)
        open(path, "wb").write(data)
        for load in (ckpt.load_with_ema_probe, lambda p: jckpt.load_with_ema_probe(p, params)):
            with pytest.raises(ValueError, match="could not deserialize .* incompatible checkpoint layout"):
                load(path)
    for load in (ckpt.load_with_ema_probe, lambda p: jckpt.load_with_ema_probe(p, params)):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "missing.ckpt"))
    orbax = str(tmp_path / "good.orbax")
    ckpt.save_checkpoint(orbax, {"params": params, "ema_params": (params,), "step": 1})
    _assert_same_tree(ckpt.load_with_ema_probe(orbax),
                      ckpt.load_with_ema_probe(good))
    with pytest.raises(FileNotFoundError):
        ckpt.load_with_ema_probe(str(tmp_path / "missing.orbax"))
    (data_file,) = (tmp_path / "good.orbax" / "d").iterdir()
    raw = bytearray(data_file.read_bytes())
    raw[-10] ^= 0xFF  # inside the B+tree node, after the values
    data_file.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="could not deserialize .* incompatible checkpoint layout"):
        ckpt.load_with_ema_probe(orbax)


def test_discovery_matches_jax(tmp_path):
    """find_best_checkpoint (sidecar, name parse, the ("direct", 1000)
    fallback, newest by mtime, an .orbax directory, none) and
    parse_resume_step_from_filename give JAX's answers."""
    def both(d, contr):
        ours, ref = ckpt.find_best_checkpoint(str(d), contr), jckpt.find_best_checkpoint(str(d), contr)
        assert ours == ref
        return ours

    d = tmp_path / "c"
    d.mkdir()
    assert both(d, "t1c") is None
    a = d / "brats_t1c_BEST_sampled_10.ckpt"
    a.write_bytes(b"")
    os.utime(a, (1000, 1000))
    assert both(d, "t1c") == (str(a), "sampled", 10)
    b = d / "brats_t1c_BEST_odd.ckpt"
    b.write_bytes(b"")
    os.utime(b, (2000, 2000))
    assert both(d, "t1c") == (str(b), "direct", 1000)
    (d / "brats_t1c_BEST_odd.ckpt.json").write_text(
        json.dumps({"sample_schedule": "linear", "diffusion_steps": "250"}))
    assert both(d, "t1c") == (str(b), "linear", 250)
    o = d / "brats_t1c_BEST_sampled_25.orbax"
    o.mkdir()
    os.utime(o, (3000, 3000))
    assert both(d, "t1c") == (str(o), "sampled", 25)
    assert both(d, "t2f") is None
    names = ["brats_t1c_000200_sampled_10.ckpt", "brats_t1c_1234567_linear_1000.orbax",
             "brats_t1c_BEST_sampled_10.ckpt", "opt001500.ckpt", "opt_brats_t1c_000300_sampled_10.ckpt",
             "x/y/brats_t2w_000042_sampled_10.ckpt", "weird.ckpt", "opt12.pt"]
    for n in names:
        assert ckpt.parse_resume_step_from_filename(n) == jckpt.parse_resume_step_from_filename(n)
    for args in (("t1c", "sampled", 10), ("t2f", "linear", 1000, "brats", ".ckpt")):
        assert ckpt.best_checkpoint_name(*args) == jckpt.best_checkpoint_name(*args)
    assert ckpt.step_checkpoint_name("t1n", 42, "sampled", 10) == \
        jckpt.step_checkpoint_name("t1n", 42, "sampled", 10)
    ckpt.save_best_losses(str(d), {"t1c": 0.5, "t1n": 0.25})
    assert ckpt.load_best_losses(str(d)) == jckpt.load_best_losses(str(d)) == {"t1c": 0.5, "t1n": 0.25}
    for s in ("0", "false", "No", "OFF", "none", "", "1", "yes", "x", True, False):
        assert common.str2bool(s) == jcommon.str2bool(s)


@pytest.mark.parametrize("flags", [{}, dict(resblock_updown=False)], ids=["updown", "conv_resample"])
def test_weight_maps_match_bridge(flags):
    """jax_params_from_state_dict equals the JAX package's torch_to_flax,
    and state_dict_from_jax inverts it; leftovers raise."""
    cfg = common.production_config(**TINY, **flags)
    model, sd, jmodel = _seeded(cfg)
    ours = jax_params_from_state_dict(model.state_dict(), model)
    ref = bridge.torch_to_flax(sd, jmodel)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and a.shape == b.shape and np.array_equal(a, b)
    back = state_dict_from_jax(ours, model)
    assert back.keys() == model.state_dict().keys()
    assert all(torch.equal(back[k], torch.from_numpy(sd[k])) for k in sd)
    with pytest.raises(KeyError, match="unconsumed"):
        jax_params_from_state_dict({**model.state_dict(), "extra.weight": torch.zeros(1)}, model)
    with pytest.raises(KeyError, match="unconsumed"):
        state_dict_from_jax({**ours, "in_0_attn": {"qkv": {"kernel": np.zeros((2, 2))}}}, model)


def test_convert_checkpoint_crossed_with_jax(tmp_path):
    """.pt → .ckpt and .ckpt → .pt on both sides, crossed: the port's
    imported .ckpt has the bytes of JAX's; each side's export of the
    other's .ckpt gives the original weights bit for bit."""
    cfg = common.production_config(**TINY)
    _, sd, _ = _seeded(cfg)
    pt = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    flags = [f"--{k}={v}" for k, v in cfg.items() if k in common.PRODUCTION_OVERRIDES] + [
        "--contr=t1c", "--diffusion_steps=10"]
    ours_ck, ref_ck = str(tmp_path / "ours.ckpt"), str(tmp_path / "ref.ckpt")
    convert_checkpoint.main(["--src", pt, "--dst", ours_ck] + flags)
    jconvert.main(["--src", pt, "--dst", ref_ck] + flags)
    assert open(ours_ck, "rb").read() == open(ref_ck, "rb").read()
    side = {k: v for k, v in json.load(open(ours_ck + ".json")).items() if k != "imported_from"}
    assert side == {k: v for k, v in json.load(open(ref_ck + ".json")).items() if k != "imported_from"}
    for src, conv in ((ref_ck, convert_checkpoint.main), (ours_ck, jconvert.main)):
        out = src + ".pt"
        conv(["--src", src, "--dst", out] + flags)
        back = torch.load(out, weights_only=True)
        assert back.keys() == sd.keys()
        assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)


def _vols(seed):
    rng = np.random.default_rng(seed)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32) for m in MODALITIES}
    vols["t1n"][:, :4] = 0.0  # background the mask zeroes
    return vols


@pytest.mark.parametrize("sampler,use_ema", [("ddpm", True), ("ddim", False), ("dpm++", True)])
def test_load_best_synthesis_matches_jax(tmp_path, monkeypatch, sampler, use_ema):
    """Both sides' load_best_synthesis on one JAX-written .ckpt whose EMA
    shadow differs from its params, with a JAX sidecar (extra keys
    included): the same config, the EMA exactly when use_ema, and images
    within atol 1e-4 (fp32) with JAX's noise handed to the port."""
    cfg = common.production_config(**TINY)
    _, sd, jmodel = _seeded(cfg)
    _, sd_ema, _ = _seeded(cfg, scale=0.5)
    params, ema = bridge.torch_to_flax(sd, jmodel), bridge.torch_to_flax(sd_ema, jmodel)
    path = str(tmp_path / "brats_t1c_BEST_sampled_10.ckpt")
    jckpt.save_checkpoint(path, {"params": params, "ema_params": (ema,), "step": 3},
                          config={**cfg, "contr": "t1c", "lr": 1e-4, "imported_from": "x.pt"})
    seen = {}
    for name, mod in (("jax", jcommon), ("port", common)):
        orig = mod.build_model_and_diffusion
        monkeypatch.setattr(mod, "build_model_and_diffusion",
                            lambda c, n=name, o=orig: (seen.__setitem__(n, dict(c)), o(c))[1])
    steps = {"ddpm": None, "ddim": 5, "dpm++": 4}[sampler]
    kw = dict(use_ema=use_ema, sampler=sampler, sampler_steps=steps, dtype="float32")
    ref_fn = jcommon.load_best_synthesis(str(tmp_path), "t1c", **kw)
    fn = common.load_best_synthesis(str(tmp_path), "t1c", device="cpu", **kw)
    assert seen["port"] == seen["jax"]
    assert seen["port"].get("timestep_respacing", "") == ("ddim5" if sampler == "ddim" else "")
    vols, key = _vols(2), jax.random.PRNGKey(4)
    ref = ref_fn(jcommon.prepare_condition(vols, "t1c"), vols["t1n"], key)
    shape = (1, 8, 8, 8, 8)
    # dpm++ draws its latent from the key itself, ddim from the first split
    # (eta 0: no step noise), ddpm also its step noise from the second
    key_init, key_loop = jax.random.split(key)
    noise = np.array(jax.random.normal(key if sampler == "dpm++" else key_init, shape, jnp.float32))
    step_noise = None
    if sampler == "ddpm":
        step_noise = np.stack([np.array(jax.random.normal(k, shape, jnp.float32))
                               for k in jax.random.split(key_loop, 10)])
    ours = fn(common.prepare_condition(vols, "t1c", device="cpu"), vols["t1n"], noise=noise,
              step_noise=step_noise)
    assert ours.shape == ref.shape == (1, 16, 16, 16)
    assert np.all(ours[:, :4] == 0.0) and ours.max() > 0.0
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    # the other choice of weights gives another image: the pick is visible
    other = common.load_best_synthesis(str(tmp_path), "t1c", device="cpu",
                                       **dict(kw, use_ema=not use_ema))
    alt = other(common.prepare_condition(vols, "t1c", device="cpu"), vols["t1n"], noise=noise,
                step_noise=step_noise)
    assert np.abs(alt - ref).max() > 1e-2


def test_load_params_refuses_what_the_port_lacks(tmp_path, capsys):
    """A .ckpt with parameters the port does not implement raises instead
    of loading partially; use_ema on a file without shadows warns and
    loads the raw parameters; an .orbax of the same parameters loads them
    alike, and a missing one raises FileNotFoundError."""
    cfg = common.production_config(**TINY)
    model, sd, jmodel = _seeded(cfg)
    params = bridge.torch_to_flax(sd, jmodel)
    path = str(tmp_path / "a.ckpt")
    ckpt.save_checkpoint(path, {"params": {**params, "mid_attn": {"qkv": {"kernel": np.ones((4, 12), np.float32)}}},
                                "ema_params": (), "step": 0})
    with pytest.raises(KeyError, match="mid_attn"):
        common.load_params(path, model)
    ckpt.save_checkpoint(path, {"params": params, "ema_params": (), "step": 0})
    fresh, _ = common.build_model_and_diffusion(cfg)
    _, applied = common.load_params_ex(path, fresh, use_ema=True)
    assert not applied and "no EMA shadows" in capsys.readouterr().out
    assert all(torch.equal(fresh.state_dict()[k], torch.from_numpy(sd[k])) for k in sd)
    orbax = str(tmp_path / "b.orbax")
    ckpt.save_checkpoint(orbax, {"params": params, "ema_params": (), "step": 0})
    other, _ = common.build_model_and_diffusion(cfg)
    _, applied = common.load_params_ex(orbax, other, use_ema=True)
    assert not applied and "no EMA shadows" in capsys.readouterr().out
    assert all(torch.equal(other.state_dict()[k], torch.from_numpy(sd[k])) for k in sd)
    with pytest.raises(FileNotFoundError):
        common.load_params(str(tmp_path / "missing.orbax"), fresh)
