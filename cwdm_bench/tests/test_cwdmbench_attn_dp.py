"""The cells that need drivers of their own, ``synth10.attn.bf16``
(``synthesis_attn.py``) and ``train.bf16.dp4`` (``training_dp.py``), on the
CPU at a tiny size: each once sound and once with a fault planted in the
program underneath, which must read not correct; a rank that dies; the
attention counts and the new readers on made-up records; and what a run
loads. ``train.bf16.dp4`` runs two gloo ranks here, standing in for NCCL's
four: the faults are planted in both (rank 1 through a ``sitecustomize``
module on its ``PYTHONPATH``)."""

import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cwdm_bench import harness
from cwdm_bench.counts import attention, unet
from cwdm_bench.reference import cwdm_attn
from cwdm_bench.tests import tiny

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 17


def attn_config() -> dict:
    """cwdm-attn-bf16 at the tiny size, in fp32 (where the program's CPU path
    and the reference agree to round-off): attention at ds 2 (512 positions
    of the 16³ latent, 4 heads of 16) and in the bottleneck."""
    cfg = tiny.config("cwdm-attn-bf16")
    cfg["model"].update(attention_resolutions="56", num_head_channels=16, dtype="float32")
    cfg["precision"]["compute"] = "float32"
    return cfg


def run_attn(seconds: float = 0.5) -> dict:
    return harness.run_cell("synth10.attn.bf16", SEED, seconds, False, device="cpu",
                            config=attn_config(), traffic=tiny.traffic("synth10.attn.bf16"))


def run_dp(ranks: int = 2, seconds: float = 1.0) -> dict:
    tr = dict(tiny.traffic("train.bf16.dp4"), ranks=ranks)
    return harness.run_cell("train.bf16.dp4", SEED, seconds, False, device="cpu",
                            config=tiny.config("cwdm-fp32"), traffic=tr)


# -- synthesis_attn -----------------------------------------------------------

def _attention_output_off(monkeypatch):
    """Every attention block returns its input: the blocks' residual branch
    left out."""
    from fast_cwdm_tpu_torch.models.unet import AttentionBlock

    monkeypatch.setattr(AttentionBlock, "forward", lambda self, x, emb=None: x)


def _scale_left_out(monkeypatch):
    """The attention product without its 1/√√ch scaling of q and k."""
    from fast_cwdm_tpu_torch.ops import attention as attn

    real = attn.attention

    def unscaled(q, k, v, scale):
        return real(q, k, v, 1.0)

    unscaled.launches = real.launches
    monkeypatch.setattr(attn, "attention", unscaled)


def _other_head_order(monkeypatch):
    """Every block reads qkv in the other head order than its weights'."""
    from fast_cwdm_tpu_torch.models.unet import AttentionBlock

    real = AttentionBlock.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.new_order = not self.new_order

    monkeypatch.setattr(AttentionBlock, "__init__", init)


@pytest.mark.parametrize("fault", [None, _attention_output_off, _scale_left_out,
                                   _other_head_order])
def test_attention_synthesis(monkeypatch, fault):
    if fault:
        fault(monkeypatch)
    out = run_attn()
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None), out["limits"]


# -- training_dp -------------------------------------------------------------

HALF_BATCH = """
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
_real = pmesh.all_reduce_mean_
def all_reduce_mean_(mesh, tensors, log=None, **kw):
    # the upper half of the data axis adds no gradient: its rows left out
    if mesh.rank >= mesh.size // 2:
        for t in tensors[:len(tensors) - kw.get("replicated", 0)]:
            t.zero_()
    _real(mesh, tensors, log, **kw)
pmesh.all_reduce_mean_ = all_reduce_mean_
"""
NO_EXCHANGE = """
from fast_cwdm_tpu_torch.parallel import mesh as pmesh
pmesh.all_reduce_mean_ = lambda *a, **kw: None
"""
RANK_DIES = """
import os
from fast_cwdm_tpu_torch.training import train
_real = train.make_train_step
def make_train_step(*a, **kw):
    step, calls = _real(*a, **kw), [0]
    def dying(*x, **y):
        calls[0] += 1
        if calls[0] > 4:  # in the window
            os._exit(3)
        return step(*x, **y)
    return dying
train.make_train_step = make_train_step
"""


def _plant(monkeypatch, tmp_path, code: str) -> None:
    """``code`` run in this process (rank 0) and, as ``sitecustomize``, in
    every rank the driver starts."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(code))
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(p for p in (str(tmp_path), path) if p))
    from fast_cwdm_tpu_torch.parallel import mesh as pmesh
    from fast_cwdm_tpu_torch.training import train

    monkeypatch.setattr(pmesh, "all_reduce_mean_", pmesh.all_reduce_mean_)
    monkeypatch.setattr(train, "make_train_step", train.make_train_step)
    exec(compile(code, "planted", "exec"), {})


def test_data_parallel_training_is_correct_and_the_ranks_agree():
    out = run_dp()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is True, out["limits"]
    assert out["limits"]["rank_gap"] == [0.0, 0.0]
    assert out["device"]["count"] == 2


@pytest.mark.parametrize("fault", [HALF_BATCH, NO_EXCHANGE], ids=["half_batch", "no_exchange"])
def test_data_parallel_training_faults(monkeypatch, tmp_path, fault):
    _plant(monkeypatch, tmp_path, fault)
    out = run_dp()
    assert out["attempted"] > 0
    assert out["correct"] is False, out["limits"]
    if fault is NO_EXCHANGE:  # the ranks drift apart
        assert out["limits"]["rank_gap"][0] > 0


def test_a_rank_that_dies_ends_the_run_not_correct(monkeypatch, tmp_path):
    """Rank 1 exits in its window's second step (planted in the ranks the
    driver starts only)."""
    (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(RANK_DIES))
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(p for p in (str(tmp_path), path) if p))
    t = time.perf_counter()
    out = run_dp(seconds=30.0)
    assert time.perf_counter() - t < 120  # well inside the group's timeout: gloo sees the death
    assert out["correct"] is False and out["failed"] > 0


# -- counts and readers -------------------------------------------------------

def _attn_model_cfg():
    return harness.load_cell("synth10.attn.bf16")["config"]["model"]


def test_attention_sites_at_the_published_size():
    sites = attention.sites(_attn_model_cfg(), (112, 112, 80))
    assert [(s["t"], s["c"], s["heads"]) for s in sites].count((15_680, 128, 2)) == 5
    assert [(s["t"], s["c"], s["heads"]) for s in sites].count((1_960, 256, 4)) == 5
    assert [(s["t"], s["c"], s["heads"]) for s in sites].count((245, 256, 4)) == 6
    flash = sum(attention.flash_operations(s) for s in sites)
    assert flash == pytest.approx(6.494455296e11, rel=1e-12)
    assert attention.flash_operations(sites[0]) == pytest.approx(1.259e11, rel=1e-3)


def test_forward_operations_match_torch_counter():
    cfg = attn_config()["model"]
    p = harness.draw_weights(cwdm_attn.param_shapes(cfg), 0, torch.device("cpu"))
    x = torch.zeros((2, 16, 16, 16, 32))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        cwdm_attn.unet(p, cfg, x, torch.zeros(2, dtype=torch.long))
    assert attention.forward_operations(cfg, (16, 16, 16), batch=2) == fc.get_total_flops()
    assert attention.forward_operations(cfg, (16, 16, 16)) > unet.forward_operations(
        cfg, (16, 16, 16))


def _attn_record(kernels, launched, missing=None):
    return {"trace": {"kernels": kernels, "launched": launched, "records_missing": missing or {},
                      "busy_s": 1.0, "window_s": 1.1},
            "model": _attn_model_cfg(), "latent": (112, 112, 80), "batch": 1,
            "trace_items": 2, "forwards_per_item": 10, "items": 100, "window_s": 50.0}


def test_attn_roofline_reads_the_flash_records():
    read = harness.load_reader("attn_roofline.attn")
    kernels = {"void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64>>": [0.05, 100],
               "void pytorch_flash::flash_fwd_splitkv_kernel<...>": [0.01, 120],
               "void pytorch_flash::flash_fwd_splitkv_combine_kernel<...>": [0.002, 120],
               "conv3d_wgmma_kernel": [0.3, 600]}
    got = read(_attn_record(kernels, {"attention": 220}))  # a combine record is no launch's
    pk = unet.peaks()
    bound = attention.flash_bound_s(_attn_model_cfg(), (112, 112, 80), pk["ops_per_s"]["bfloat16"],
                                    pk["bytes_per_s"], 2)
    assert got == pytest.approx(100.0 * bound * 20 / 0.062)
    assert 0 < got <= 100


def test_attn_roofline_is_left_out_where_a_flash_record_is_lost_or_nothing_ran():
    read = harness.load_reader("attn_roofline.attn")
    lost = {"void pytorch_flash::flash_fwd_kernel<...>": [0.05, 319]}
    assert read(_attn_record(lost, {"attention": 320})) is None
    # a lost split-KV record is not made up for by the combine records
    split_lost = {"void pytorch_flash::flash_fwd_kernel<...>": [0.05, 100],
                  "void pytorch_flash::flash_fwd_splitkv_kernel<...>": [0.01, 119],
                  "void pytorch_flash::flash_fwd_splitkv_combine_kernel<...>": [0.002, 120]}
    assert read(_attn_record(split_lost, {"attention": 220})) is None
    assert read(_attn_record({"conv3d_wgmma_kernel": [0.3, 600]}, {})) is None  # the einsum path


def test_mfu_attn_counts_the_attention_blocks():
    read = harness.load_reader("mfu.attn")
    rec = _attn_record({}, {})
    ops = attention.forward_operations(_attn_model_cfg(), (112, 112, 80))
    assert read(rec) == pytest.approx(100.0 * ops * 100 * 10 / 50.0 / 989e12)
    assert ops == pytest.approx(unet.forward_operations(_attn_model_cfg(), (112, 112, 80))
                                + 6.6563030016e11, rel=1e-12)


def test_allreduce_ms_reads_the_span_a_step(monkeypatch):
    """Each rank's span ms a device-only step (the driver's part), and the
    reader's median over the steps of the largest rank."""
    from cwdm_bench import training_dp
    from fast_cwdm_tpu_torch.utils import profiling

    spans, sid = [], [0]

    def span(name, parent, root, device_ms):
        sid[0] += 1
        spans.append({"name": name, "id": sid[0], "parent": parent, "root": root or sid[0],
                      "device_ms": device_ms, "host_ms": 1.0, "counts": {}})
        return sid[0]

    for ms in (50.0, 40.0, 70.0, 1.0, 1.0, 1.0):  # the device-only block, then the host-traced
        root = span("cwdm.train.step", None, None, 400.0)
        span("cwdm.train.allreduce", root, root, ms)
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert training_dp.allreduce_ms(3) == [50.0, 40.0, 70.0]
    nan = [math.isnan(v) for v in training_dp.allreduce_ms(4)]
    assert nan == [True] * 4  # fewer steps recorded than traced
    spans[:] = [s for s in spans if s["name"] != "cwdm.train.allreduce"]  # a program without it
    assert all(math.isnan(v) for v in training_dp.allreduce_ms(3))

    read = harness.load_reader("allreduce_ms.dp")
    # rank 1 waited for rank 0 in steps 0 and 2, rank 0 for rank 1 in step 1
    assert read({"allreduce_ms_by_rank": [[50.0, 40.0, 70.0], [60.0, 30.0, 90.0]]}) == 60.0
    assert read({"allreduce_ms_by_rank": None}) is None  # a rank without the span
    assert read({"trace_items": 3}) is None  # a driver that reports no ranks


def test_a_traced_data_parallel_run_traces_every_rank():
    """``--trace 1``: every rank runs the traced blocks; on the CPU the spans
    have no device events, so the all-reduce is not read."""
    tr = dict(tiny.traffic("train.bf16.dp4"), ranks=2)
    out = harness.run_cell("train.bf16.dp4", SEED, 0.5, True, device="cpu",
                           config=tiny.config("cwdm-fp32"), traffic=tr)
    assert out["correct"] is True, out["limits"]
    assert "allreduce_ms.dp" not in out["metrics"]
    assert "busy_s" in out["device"]  # rank 0's traced block (no device records on the CPU)


# -- what a run loads ----------------------------------------------------------

RUN_TINY = """
import json, sys
sys.path.insert(0, {root!r})
from cwdm_bench.tests import test_cwdmbench_attn_dp as t
assert t.run_attn()["attempted"] > 0
assert t.run_dp()["attempted"] > 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_new_drivers_load_neither_jax_nor_the_jax_package():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(root=str(ROOT))], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=900, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fast_cwdm_tpu_torch" in top and "cwdm_bench" in top
    assert not top & {"jax", "jaxlib", "flax", "fast_cwdm_tpu"}, sorted(top)
