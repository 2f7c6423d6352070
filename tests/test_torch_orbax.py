"""The port's ``.orbax`` backend against the real one: its zstd decoder
against ``zstandard`` (every block, literal and sequence kind), its OCDBT
reader and writer against tensorstore's own ``ocdbt`` store, whole
checkpoints against the JAX package's ``save_checkpoint`` (``.ckpt`` and
``.orbax`` of the same payload load into the same tree) and Orbax's
restore, TrainLoop resumes across the packages through ``.orbax``, and the
committed fixtures ``tests/golden/orbax_tiny.orbax`` and
``opt_tiny.orbax`` (written by the JAX package, read here with
tensorstore, orbax and zstandard unimportable).

The fixtures are written by :func:`write_fixtures`, run by hand:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_orbax.py``; with
``--production DIR`` it runs :func:`read_production` instead and prints
one JSON line: the host seconds of the port reading tensorstore's
``.orbax`` of the production weights, and its decoder's MB/s by frame kind.
"""

import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard

from fast_cwdm_tpu.training import checkpoints as jckpt
from fast_cwdm_tpu.training import orbax_io as jorbax
from fast_cwdm_tpu_torch.training import checkpoints as ckpt
from fast_cwdm_tpu_torch.training import ocdbt, orbax_io, zstd

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
ORBAX = ("orbax", "tensorstore", "zstandard")


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes(),
        "zeros": bytes(4000),
        "arange": np.arange(262_144, dtype=np.float32).tobytes(),
        "gauss": rng.standard_normal(262_144).astype(np.float32).tobytes(),  # 1 MiB
        "json": json.dumps({"chunks": [3, 4], "compressor": {"id": "zstd", "level": 1},
                            "dtype": "<f4", "shape": list(range(40))}).encode(),
    }


INPUTS = _inputs()
CASES = [(lvl, ck, name) for lvl in (1, 3, 19) for ck in (False, True) for name in INPUTS]


def _frame(level, checksum, name):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(INPUTS[name])


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level,checksum,name", CASES)
def test_zstd_decodes_what_zstandard_writes(level, checksum, name):
    frame = _frame(level, checksum, name)
    assert zstd.decompress(frame) == INPUTS[name]
    (stats,) = zstd.frame_stats(frame)
    if name == "random":  # incompressible: zstd stores it
        assert stats["raw_blocks"] == 3 and stats["compressed_blocks"] == 0
    elif name == "gauss":  # the exponent bytes compress: Huffman literals, 8+ blocks
        assert stats["compressed_blocks"] >= 8 and stats["lit_huffman"] >= 1
    else:
        assert stats["compressed_blocks"] >= 1


def test_zstd_cases_cover_every_block_literal_and_sequence_kind():
    total = dict.fromkeys(zstd.STATS, 0)
    for case in CASES:
        for k, v in zstd.frame_stats(_frame(*case))[0].items():
            total[k] += v
    # zstandard writes no RLE block for these inputs; the port's writer does
    total["rle_blocks"] += zstd.frame_stats(zstd.compress(bytes(300_000)))[0]["rle_blocks"]
    assert all(total[k] > 0 for k in zstd.STATS), total


def test_zstd_writer_frames_decode_in_zstandard_and_back():
    rng = np.random.default_rng(1)
    for data in (b"", b"x", bytes(300_000), rng.integers(0, 256, 400_000, np.uint8).tobytes(),
                 b"ab" * 70_000, bytes(255), bytes(65_791), bytes(65_792)):
        frame = zstd.compress(data)
        assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 24) == data
        assert zstd.decompress(frame) == data
    stats = zstd.frame_stats(zstd.compress(bytes(300_000)))[0]
    assert stats["rle_blocks"] == 3 and stats["raw_blocks"] == 0


def test_zstd_frames_back_to_back_skippable_and_many():
    a, b = _frame(3, True, "json"), zstd.compress(INPUTS["zeros"])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    assert zstd.decompress(a + skip + b + a) == INPUTS["json"] + INPUTS["zeros"] + INPUTS["json"]
    got = zstd.decompress_many([a, b"", b + a, _frame(1, False, "gauss")])
    assert [g.tobytes() for g in got] == [INPUTS["json"], b"", INPUTS["zeros"] + INPUTS["json"],
                                          INPUTS["gauss"]]


def test_zstd_rejects_corrupt_frames():
    frame = _frame(3, True, "gauss")
    with pytest.raises(ValueError):
        zstd.decompress(frame[:-100])
    bad = bytearray(frame)
    bad[-1] ^= 1  # the checksum
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad))
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0x55  # inside a Huffman stream: bad stream or checksum
    with pytest.raises(ValueError):
        zstd.decompress(bytes(bad))
    # a dictionary ID (flag 1, id 7), then a raw last block of 1 byte
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes([0x28, 0xB5, 0x2F, 0xFD, 0x21, 7, 1, 9, 0, 0, 0x61]))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"not a frame")


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------


def _ts_items(root: str) -> dict[str, bytes]:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(root)}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _payload(n_ema=1, seed=0, bf16=True):
    rng = np.random.default_rng(seed)
    params = {"in_conv": {"kernel": rng.standard_normal((3, 3, 3, 4, 8)).astype(np.float32),
                          "bias": rng.standard_normal(8).astype(np.float32)},
              "big": {"kernel": rng.standard_normal((300, 300)).astype(np.float32)},
              "norm": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}}
    if bf16:
        params["half"] = {"kernel": np.asarray(jnp.asarray(rng.standard_normal((5, 3)),
                                                           jnp.bfloat16))}
    ema = tuple(jax.tree.map(lambda x: (x * (0.5 + i)).astype(x.dtype), params)
                for i in range(n_ema))
    return {"params": params, "ema_params": ema, "step": 7}


def test_ocdbt_reader_equals_tensorstore(tmp_path):
    path = str(tmp_path / "a.orbax")
    jorbax.save(path, _payload(2))
    ref = _ts_items(path)
    db = ocdbt.Reader(path)
    assert db.list() == sorted(ref) and len(ref) > 10
    assert all(db.read(k) == v for k, v in ref.items())
    # the big chunk is an indirect value in the process database's data file
    assert any(p.startswith("ocdbt.process_0/") for p, *_ in db._values.values())


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    items = {f"k{i:03d}/{'x' * (i % 5)}": rng.integers(0, 256, int(rng.integers(0, 3000)),
                                                        np.uint8).tobytes() for i in range(200)}
    for limit in (ocdbt.MAX_DECODED_NODE_BYTES, 3000):  # 3000 forces interior nodes
        root = str(tmp_path / f"db{limit}")
        monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", limit)
        ocdbt.write(root, items)
        assert _ts_items(root) == items
        db = ocdbt.Reader(root)
        assert db.list() == sorted(items) and all(db.read(k) == v for k, v in items.items())


def test_ocdbt_corruption_raises_with_the_path(tmp_path):
    root = str(tmp_path / "db")
    ocdbt.write(root, {"a": b"x" * 5000, "b": b"small"})
    (data,) = os.listdir(os.path.join(root, "d"))
    full = os.path.join(root, "d", data)
    good = open(full, "rb").read()
    bad = bytearray(good)
    bad[-8] ^= 1  # inside the leaf node, after the values
    open(full, "wb").write(bytes(bad))
    with pytest.raises(ValueError, match=data):
        ocdbt.Reader(root)
    open(full, "wb").write(good[:-20])
    with pytest.raises(ValueError, match="truncated"):
        ocdbt.Reader(root)
    os.remove(full)
    with pytest.raises(ValueError, match="missing OCDBT data file"):
        ocdbt.Reader(root)
    mf = os.path.join(root, "manifest.ocdbt")
    raw = bytearray(open(mf, "rb").read())
    raw[20] ^= 1
    open(mf, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Reader(root)


# ---------------------------------------------------------------------------
# Whole checkpoints
# ---------------------------------------------------------------------------


def _same(ours, ref, path=""):
    """Bit for bit: the same keys, dtypes, shapes and bytes."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), (path, ours, ref)
        for k in ref:
            _same(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, torch.Tensor):
        assert isinstance(ours, torch.Tensor) and ours.dtype == ref.dtype, path
        assert torch.equal(ours.view(torch.int16), ref.view(torch.int16)), path
    else:
        assert isinstance(ours, np.ndarray), (path, type(ours))
        ref = np.asarray(ref)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path


def _adamw_state(params):
    tx = optax.chain(optax.scale_by_adam(), optax.add_decayed_weights(0.0),
                     optax.scale_by_schedule(lambda c: 1.0))
    state = tx.init(params)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.1, params)
    _, state = tx.update(grads, state, params)
    return state


@pytest.mark.parametrize("n_ema", [0, 1, 2, 3])
def test_jax_orbax_and_ckpt_load_into_the_same_tree(tmp_path, monkeypatch, n_ema):
    payload = _payload(n_ema, seed=n_ema)
    opt = {"opt_state": _adamw_state({k: v for k, v in payload["params"].items()
                                      if k != "half"})}
    for name, tree in (("m", payload), ("opt", opt)):
        jckpt.save_checkpoint(str(tmp_path / f"{name}.ckpt"), tree)
        monkeypatch.setenv("FAST_CWDM_CKPT_BACKEND", "orbax")
        jckpt.save_checkpoint(str(tmp_path / f"{name}.orbax"), tree)
        monkeypatch.delenv("FAST_CWDM_CKPT_BACKEND")
        jckpt.wait_for_pending_saves()
        a = ckpt.load_checkpoint(str(tmp_path / f"{name}.orbax"))
        _same(a, ckpt.load_checkpoint(str(tmp_path / f"{name}.ckpt")))
    probe = ckpt.load_with_ema_probe(str(tmp_path / "m.orbax"))
    assert len(probe["ema_params"]) == n_ema and probe["step"].shape == ()
    assert isinstance(probe["params"]["half"]["kernel"], torch.Tensor)


def test_jax_reads_the_ports_orbax_bit_for_bit(tmp_path):
    payload = _payload(2)
    opt = {"opt_state": _adamw_state(payload["params"])}
    for name, tree in (("m", payload), ("opt", opt)):
        path = str(tmp_path / f"{name}.orbax")
        host = jax.tree.map(np.asarray, tree)
        # the port's host form: its own EmptyState ({}) and bf16 tensors
        port_tree = jax.tree.map(
            lambda x: torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
            if x.dtype.name == "bfloat16" else x, host)
        if name == "opt":
            port_tree = {"opt_state": tuple({} if isinstance(s, optax.EmptyState) else
                                            s._asdict() for s in port_tree["opt_state"])}
        ckpt.save_checkpoint(path, port_tree, config={"k": 1})
        assert json.load(open(path + ".json")) == {"k": 1}
        for got in (jorbax.load(path, tree), jorbax.restore_any(path)):
            for x, y in zip(jax.tree.leaves(host), jax.tree.leaves(got), strict=True):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        again = jorbax.restore_any(path)
        if name == "opt":
            assert again["opt_state"][1] is None  # EmptyState, as JAX writes it
        else:
            assert isinstance(again["ema_params"], list) and len(again["ema_params"]) == 2


def test_every_dtype_and_scalars_load(tmp_path):
    """<f4, <f2, <i4, <i8, bool and bfloat16 arrays load as they were
    written by Orbax; a Python scalar (value type ``scalar``) as a 0-d
    array; the port's writer keeps each dtype for JAX's restore."""
    rng = np.random.default_rng(4)
    tree = {"f4": rng.standard_normal((2, 3)).astype(np.float32),
            "f2": rng.standard_normal(5).astype(np.float16),
            "i4": np.arange(6, dtype=np.int32).reshape(3, 2), "i8": np.arange(4, dtype=np.int64),
            "b": np.array([True, False, True]),
            "h": np.asarray(jnp.asarray(rng.standard_normal(4), jnp.bfloat16)),
            "step": 5, "lr": 0.5}
    path = str(tmp_path / "t.orbax")
    jorbax.save(path, tree)
    got = orbax_io.load(path)
    for k, v in tree.items():
        if k == "h":
            assert torch.equal(got[k].view(torch.int16), torch.from_numpy(v.view(np.int16)))
            continue
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k], v), k
    again = str(tmp_path / "again.orbax")
    orbax_io.save(again, got)
    back = jorbax.restore_any(again)
    for k, v in tree.items():
        v, b = np.asarray(v), np.asarray(back[k])
        assert b.dtype == v.dtype and b.tobytes() == v.tobytes(), k


def test_multi_chunk_zarr_arrays_assemble(tmp_path):
    """A leaf that tensorstore's zarr TensorStore writes over the OCDBT store
    in 2x3 chunks (with partial edge chunks) loads whole."""
    root = str(tmp_path / "c.orbax")
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((5, 7)).astype(np.float32)
    z = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/"},
                 "path": "a.b", "metadata": {"shape": [5, 7], "chunks": [2, 3], "dtype": "<f4",
                                              "compressor": {"id": "zstd", "level": 3}},
                 "create": True}).result()
    z.write(arr).result()
    keys = [{"key": "a", "key_type": 2}, {"key": "b", "key_type": 2}]
    meta = {"tree_metadata": {"('a', 'b')": {"key_metadata": keys, "value_metadata": {
        "value_type": "np.ndarray", "skip_deserialize": False}}}, "use_ocdbt": True,
        "use_zarr3": False}
    open(os.path.join(root, "_METADATA"), "w").write(json.dumps(meta))
    assert len(ocdbt.Reader(root).list()) == 1 + 3 * 3
    got = orbax_io.load(root)["a"]["b"]
    assert got.dtype == np.float32 and np.array_equal(got, arr)


def test_save_replaces_and_commits_by_rename(tmp_path):
    path = str(tmp_path / "x.orbax")
    os.makedirs(path)
    open(os.path.join(path, "stale"), "w").write("old")
    orbax_io.save(path, {"step": np.asarray(3)})
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt"]
    assert not [p for p in os.listdir(tmp_path) if "tmp" in p]
    assert orbax_io.load(path)["step"] == 3 and orbax_io.is_orbax_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        orbax_io.load(str(tmp_path / "none.orbax"))


def test_checkpoint_ext_names_and_save_if_best(tmp_path, monkeypatch):
    """The active format follows FAST_CWDM_CKPT_BACKEND as in JAX; save_if_best
    writes opt_best in it and removes the other format's sibling."""
    for env in (None, "orbax"):
        if env:
            monkeypatch.setenv("FAST_CWDM_CKPT_BACKEND", env)
        assert ckpt.checkpoint_ext() == jckpt.checkpoint_ext()
        assert (ckpt.best_checkpoint_name("t1n", "sampled", 10)
                == jckpt.best_checkpoint_name("t1n", "sampled", 10))
        assert ckpt.step_checkpoint_name("t1n", 5, "s", 10) == jckpt.step_checkpoint_name("t1n", 5, "s", 10)
        assert ckpt.opt_checkpoint_name("t1n", 5, "s", 10) == jckpt.opt_checkpoint_name("t1n", 5, "s", 10)
    payload = _payload(1, bf16=False)
    monkeypatch.delenv("FAST_CWDM_CKPT_BACKEND")
    opt = {"opt_state": ({"count": np.int32(1)}, {}, {})}
    assert ckpt.save_if_best(str(tmp_path), "t1n", 2.0, payload, opt, sample_schedule="s",
                             diffusion_steps=10)
    assert (tmp_path / "opt_best_t1n.ckpt").is_file()
    monkeypatch.setenv("FAST_CWDM_CKPT_BACKEND", "orbax")
    assert ckpt.save_if_best(str(tmp_path), "t1n", 1.0, payload, opt, sample_schedule="s",
                             diffusion_steps=10, config={"c": 1})
    assert (tmp_path / "opt_best_t1n.orbax").is_dir() and not (tmp_path / "opt_best_t1n.ckpt").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_losses.txt", "brats_t1n_BEST_s_10.orbax", "brats_t1n_BEST_s_10.orbax.json",
        "opt_best_t1n.orbax"]
    _same(ckpt.load_checkpoint(str(tmp_path / "opt_best_t1n.orbax")),
          {"opt_state": {"0": {"count": np.asarray(np.int32(1))}, "1": {}, "2": {}}})


def test_convert_checkpoint_to_and_from_orbax(tmp_path):
    """.pt → .orbax (an Orbax directory with its sidecar beside it) loads in
    JAX's Orbax as the .pt's weights; .orbax → .pt gives them back."""
    from fast_cwdm_tpu_torch.cli import common, convert_checkpoint
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    model, _ = common.build_model_and_diffusion(common.production_config(**FIXTURE_CFG))
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    pt = str(tmp_path / "w.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    flags = [f"--{k}={v}" for k, v in FIXTURE_CFG.items() if k in common.PRODUCTION_OVERRIDES]
    dst = str(tmp_path / "brats_t1c_BEST_sampled_10.orbax")
    convert_checkpoint.main(["--src", pt, "--dst", dst, "--contr=t1c"] + flags)
    assert os.path.isdir(dst) and json.load(open(dst + ".json"))["contr"] == "t1c"
    got = jorbax.restore_any(dst)
    assert got["ema_params"] == () and int(got["step"]) == 0
    ours = ckpt.load_checkpoint(dst)["params"]
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(ours), strict=True):
        assert np.asarray(a).tobytes() == b.tobytes()
    back = str(tmp_path / "back.pt")
    convert_checkpoint.main(["--src", dst, "--dst", back] + flags)
    again = torch.load(back, weights_only=True)
    assert again.keys() == sd.keys() and all(np.array_equal(again[k].numpy(), sd[k]) for k in sd)


# ---------------------------------------------------------------------------
# TrainLoop resumes through .orbax
# ---------------------------------------------------------------------------


def test_orbax_resumes_across_the_packages(tmp_path, monkeypatch):
    """Under FAST_CWDM_CKPT_BACKEND=orbax the port's loop trains 2 steps and
    writes its BEST and opt_best as .orbax; JAX's load_checkpoint reads
    them with its templates and its save_checkpoint writes them again as
    .orbax. The JAX loop resumes from the port's files, the port's loop
    from JAX's, and their next steps match, as test_torch_train_loop
    checks for .ckpt."""
    import test_torch_train_loop as tl

    tl.logger.configure(str(tmp_path / "log"), ["log"])
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    monkeypatch.setenv("FAST_CWDM_CKPT_BACKEND", "orbax")
    batch = tl._batch(1)
    _, jmodel, params = tl._models()
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    loop = tl._port_loop(pdir, batch)
    loop.run_loop()
    best = ckpt.find_best_checkpoint(str(pdir), "t1n")[0]
    assert best.endswith(".orbax") and os.path.isdir(best)
    assert ckpt.is_orbax_checkpoint(str(pdir / "opt_best_t1n.orbax"))
    jloop = tl._jax_loop(pdir, batch, resume_checkpoint=best)
    templates = {os.path.basename(best): {"params": params, "ema_params": (params,), "step": 0},
                 "opt_best_t1n.orbax": {"opt_state": jloop.tx.init(params)}}
    for name, tmpl in templates.items():
        got = jckpt.load_checkpoint(str(pdir / name), tmpl)
        jckpt.save_checkpoint(str(jdir / name), got, config=ckpt.load_checkpoint_config(best))
    jckpt.wait_for_pending_saves()
    _same(ckpt.load_checkpoint(str(jdir / "opt_best_t1n.orbax")),
          ckpt.load_checkpoint(str(pdir / "opt_best_t1n.orbax")))
    jloop.state = jloop._init_state(batch)
    jloop._apply_resume()
    ploop = tl._port_loop(jdir, batch, resume_checkpoint=str(jdir / os.path.basename(best)))
    ploop.state = ploop._init_state({k: torch.from_numpy(v) for k, v in batch.items()})
    ploop._apply_resume()
    assert ploop.resume_step == jloop.resume_step == 2
    assert ploop.state.opt_state["count"] == int(jloop.state.opt_state[0].count) == 2
    tl._equal(ploop.state.opt_state["nu"], jloop.state.opt_state[0].nu, jmodel)
    tl._equal(ploop.state.ema_params[0], jloop.state.ema_params[0], jmodel)
    tl._check_states(jloop, ploop, *tl._next_steps(jloop, ploop, batch), jmodel)


# ---------------------------------------------------------------------------
# The committed fixtures
# ---------------------------------------------------------------------------

FIXTURE_CFG = dict(num_channels=4, num_res_blocks=1, channel_mult="1,2",
                   attention_resolutions="", num_groups=2, bottleneck_attention=False,
                   image_size=8, resample_2d=False, diffusion_steps=10,
                   sample_schedule="sampled", dtype="float32")


def _flat(tree, prefix=""):
    """``{path: leaf}`` of a ``.ckpt``-form tree; an empty map is ``None``."""
    if isinstance(tree, dict):
        if not tree:
            return {prefix: None}
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _fixture_values() -> dict:
    with np.load(os.path.join(GOLDEN, "orbax_tiny.npz")) as z:
        return {k: z[k] for k in z.files}


def _check_fixture_tree(tree: dict, values: dict, prefix: str) -> None:
    flat = _flat(tree)
    empty = set(values[f"{prefix}:empty"].tolist())
    assert {k for k, v in flat.items() if v is None} == empty
    want = {k[len(prefix) + 1:]: v for k, v in values.items()
            if k.startswith(prefix + ":") and k != f"{prefix}:empty"}
    got = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            got[k + "@bfloat16"] = v.view(torch.int16).numpy()
        elif v is not None:
            got[k] = v
    assert set(got) == set(want)
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.dtype == v.dtype and g.shape == v.shape and g.tobytes() == v.tobytes(), k


def test_committed_fixture_is_genuine():
    """JAX's restore of the committed .orbax fixtures equals the .npz."""
    values = _fixture_values()
    for name, prefix in (("orbax_tiny.orbax", "ckpt"), ("opt_tiny.orbax", "opt")):
        got = jorbax.restore_any(os.path.join(GOLDEN, name))
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            leaf = np.asarray(leaf)
            if leaf.dtype.name == "bfloat16":
                key, leaf = key + "@bfloat16", leaf.view(np.int16)
            flat[key] = leaf
        want = {k[len(prefix) + 1:]: v for k, v in values.items()
                if k.startswith(prefix + ":") and k != f"{prefix}:empty"}
        assert set(flat) == set(want)
        for k, v in want.items():
            assert flat[k].dtype == v.dtype and flat[k].tobytes() == v.tobytes(), k


def test_committed_fixture_reads_without_tensorstore(monkeypatch):
    """The port reads tensorstore's own bytes with no zstd, OCDBT or Orbax
    package importable: the same values as the .npz, bit for bit; and the
    fixture's frames hit Huffman literals and several blocks."""
    for mod in ORBAX:
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError):
        import zstandard  # noqa: F401, F811
    values = _fixture_values()
    tree = ckpt.load_checkpoint(os.path.join(GOLDEN, "orbax_tiny.orbax"))
    _check_fixture_tree(tree, values, "ckpt")
    assert len(ckpt.load_with_ema_probe(os.path.join(GOLDEN, "orbax_tiny.orbax"))["ema_params"]) == 2
    _check_fixture_tree(ckpt.load_checkpoint(os.path.join(GOLDEN, "opt_tiny.orbax")), values, "opt")
    db = ocdbt.Reader(os.path.join(GOLDEN, "orbax_tiny.orbax"))
    stats = zstd.frame_stats(db.read("extra.gauss/0"))[0]
    assert stats["compressed_blocks"] >= 8 and stats["lit_huffman"] >= 1


def write_fixtures(dest: str = GOLDEN) -> None:
    """Write the committed fixtures with the JAX package (run by hand)."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    model, _ = common.build_model_and_diffusion(common.production_config(**FIXTURE_CFG))
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    params = jax_params_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, model)
    # weights rounded to 8 significant bits (as float32) keep the fixture small
    params = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), params)
    ema = tuple(jax.tree.map(lambda x: (x * np.float32(r)).astype(np.float32), params)
                for r in (0.5, 0.25))
    rng = np.random.default_rng(12)
    # 1 MiB of N(0, 1) truncated to 4 significant bits: Huffman literals
    # over several blocks, and a fixture that stays small
    gauss = (rng.standard_normal(262_144).astype(np.float32).view(np.uint32)
             & np.uint32(0xFFE00000)).view(np.float32)
    half = np.asarray(jnp.asarray(rng.standard_normal((6, 5)), jnp.bfloat16))
    payload = {"params": params, "ema_params": ema, "step": np.asarray(7),
               "extra": {"gauss": gauss, "half": half}}
    opt = {"opt_state": _adamw_state(params)}
    values = {}
    for prefix, tree in (("ckpt", payload), ("opt", opt)):
        empty = []
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, optax.EmptyState))[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                           for p in path)
            if isinstance(leaf, optax.EmptyState):
                empty.append(key)
                continue
            leaf = np.asarray(leaf)
            if leaf.dtype.name == "bfloat16":
                key, leaf = key + "@bfloat16", leaf.view(np.int16)
            values[f"{prefix}:{key}"] = leaf
        values[f"{prefix}:empty"] = np.array(empty, dtype="U64")
    for name, tree in (("orbax_tiny.orbax", payload), ("opt_tiny.orbax", opt)):
        shutil.rmtree(os.path.join(dest, name), ignore_errors=True)
        jorbax.save(os.path.join(dest, name), tree)
    np.savez_compressed(os.path.join(dest, "orbax_tiny.npz"), **values)


def decoder_rates(path: str) -> dict:
    """zstd MB/s (decoded bytes over seconds) by frame kind over every
    chunk frame of an ``.orbax``: raw blocks only, Huffman literals without
    sequences, and frames with sequences."""
    db = ocdbt.Reader(path)
    groups: dict = {"raw": [], "huffman": [], "sequences": []}
    for key in db.list():
        if key.endswith("/.zarray"):
            continue
        frame = db.read(key)
        stats = zstd.frame_stats(frame)
        if any(s["seq_predefined"] + s["seq_rle"] + s["seq_fse"] + s["seq_repeat"] for s in stats):
            groups["sequences"].append(frame)
        elif any(s["lit_huffman"] + s["lit_treeless"] for s in stats):
            groups["huffman"].append(frame)
        else:
            groups["raw"].append(frame)
    out = {}
    for kind, frames in groups.items():
        if frames:
            t0 = time.perf_counter()
            n = sum(o.size for o in zstd.decompress_many(frames))
            s = time.perf_counter() - t0
            out[kind] = {"frames": len(frames), "compressed_bytes": sum(map(len, frames)),
                         "decoded_bytes": n, "seconds": s, "mb_per_s": n / s / 1e6}
    return out


def read_production(dest: str) -> dict:
    """The port reading a TPU run's checkpoint, run by hand (about 0.6 GB
    in ``dest``): the seeded production weights of ``chip_smoke.py`` with
    one EMA shadow, written by the JAX package's Orbax backend
    (tensorstore's zstd level 1), read by the port's
    ``load_with_ema_probe`` (checked bit for bit, timed), then the
    decoder's rates over its frames. Host CPU seconds."""
    import chip_smoke
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict

    cfg, sd = chip_smoke.seeded_production(torch)
    model, _ = common.build_model_and_diffusion(cfg)
    params = jax_params_from_state_dict(sd, model)
    del model, sd
    path = os.path.join(dest, "ts_production.orbax")
    jorbax.save(path, {"params": params, "ema_params": (params,), "step": np.asarray(0)})
    t0 = time.perf_counter()
    got = ckpt.load_with_ema_probe(path)
    read_s = time.perf_counter() - t0
    equal = (chip_smoke.same_tree(np, got["params"], params) and len(got["ema_params"]) == 1
             and chip_smoke.same_tree(np, got["ema_params"][0], params))
    del got
    with open("/proc/cpuinfo") as f:
        cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), "?")
    return {"cpu": cpu, "path": path, "bytes": chip_smoke.dir_bytes(path), "read_s": read_s,
            "equal_bit_for_bit": bool(equal), "decoder": decoder_rates(path)}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:2] == ["--production"]:
        print(json.dumps(read_production(sys.argv[2])))
    else:
        write_fixtures()
