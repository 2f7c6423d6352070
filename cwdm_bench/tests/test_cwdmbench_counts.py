"""The frozen counts reproduce the bounds of the port's kernel table from
the shapes, and agree with torch's own operation counter on the reference."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cwdm_bench import harness
from cwdm_bench.counts import unet
from cwdm_bench.reference import cwdm
from cwdm_bench.tests import tiny

LATENT = (112, 112, 80)


def _model():
    return harness.load_cell("synth10.bf16")["config"]["model"]


def test_fused_convs_of_a_forward():
    sites = [s for s in unet.sites(_model(), LATENT) if s["fused"]]
    assert len(sites) == 54  # 27 ResBlocks that neither up- nor downsample, two convs each
    peak = unet.peaks()["ops_per_s"]["bfloat16"]
    deep = (14 * 14 * 10, 7 * 7 * 5)
    wgmma = sum(unet.operations(s) for s in sites if s["voxels"] not in deep) / peak
    assert wgmma * 1e3 == pytest.approx(4.685, abs=5e-4)  # levels 0-2: PERF.md's bound
    total = unet.fused_bound_s(_model(), LATENT, peak, unet.peaks()["bytes_per_s"], 2)
    assert (total - wgmma) * 1e3 == pytest.approx(0.103, abs=5e-4)  # levels 3-4, split-K


def test_level_1_fp32_conv():
    site = dict(kind="conv", ci=128, co=128, k=3, voxels=56 * 56 * 40, fused=True)
    assert unet.operations(site) == pytest.approx(1.11e11, rel=2e-3)
    assert unet.operations(site) == 2 * 27 * 128 * 128 * 125_440


def test_forward_operations_match_torch_counter():
    cfg = tiny.config("cwdm-fp32")["model"]
    p = harness.draw_weights(cwdm.param_shapes(cfg), 0, torch.device("cpu"))
    x = torch.zeros((2, 16, 16, 16, 32))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        cwdm.unet(p, cfg, x, torch.zeros(2, dtype=torch.long))
    assert unet.forward_operations(cfg, (16, 16, 16), batch=2) == fc.get_total_flops()


def test_production_forward_operations():
    ops = unet.forward_operations(_model(), LATENT)
    assert math.isclose(ops, 7.168668434432e12, rel_tol=1e-12)
