"""Metric readers on records made up here: what each counts and leaves out."""

import pytest

from cwdm_bench import harness


def _synth_record(kernels, missing=None):
    return {"trace": {"kernels": kernels, "records_missing": missing or {}, "busy_s": 1.0,
                      "window_s": 1.1},
            "trace_items": 2, "forwards_per_item": 10}


def test_forward_ms_leaves_out_what_lies_outside_the_chain():
    kernels = {
        "conv3d_wgmma_kernel<64>": [0.6, 100],
        "void at::native::reduce_kernel<512, 1>": [0.2, 400],
        "Memcpy DtoD (Device -> Device)": [0.04, 40],  # inside the chain: counted
        "Memcpy HtoD (Pageable -> Device)": [0.03, 8],
        "Memcpy DtoH (Device -> Pageable)": [0.02, 2],
        "haar_dwt3_kernel": [0.001, 5],
        "haar_dwt3 (CUDA events)": [0.0002, 1],
        "haar_idwt3_kernel": [0.0004, 2],
        "void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel"
        "<float, 4, at::native::templates::cuda::normal_and_transform<float, float>>": [0.01, 4],
    }
    got = harness.load_reader("forward_ms.synth")(_synth_record(kernels))
    assert got == pytest.approx(1e3 * (0.6 + 0.2 + 0.04) / 20)


def test_forward_ms_is_left_out_where_records_are_missing():
    rec = _synth_record({"conv3d_wgmma_kernel": [0.6, 99]},
                        missing={"conv3d_wgmma": [99, 100]})
    assert harness.load_reader("forward_ms.synth")(rec) is None
