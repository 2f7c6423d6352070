"""The program's spans (``utils/profiling.py``): off without a profiler, the
tree that synthesis and the train step record under one, their intervals
against the profiler's own events, the benchmark's six readers of the
store, and (``cuda``) the captured chain's spans on the card.

This file imports no JAX, so its ``cuda`` test also runs where JAX is not
installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import contextlib
import importlib.util
import itertools
import pathlib
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fast_cwdm_tpu_torch.cli import common
from fast_cwdm_tpu_torch.training import state as tstate
from fast_cwdm_tpu_torch.training import train
from fast_cwdm_tpu_torch.utils import profiling
from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(
    num_channels=16, num_res_blocks=1, channel_mult="1,2", attention_resolutions="",
    num_groups=8, bottleneck_attention=False, image_size=8, resample_2d=False,
    diffusion_steps=10, sample_schedule="sampled", dtype="float32",
)
MODALITIES = ("t1n", "t1c", "t2w", "t2f")


def _model(device="cpu"):
    model, diffusion = common.build_model_and_diffusion(common.production_config(**TINY))
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.to(device), diffusion


def _volumes(seed=0):
    rng = np.random.default_rng(seed)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32) for m in MODALITIES}
    vols["t1n"][:, :4] = 0.0
    return vols


@pytest.fixture(scope="module")
def synthesize():
    """One request as the synthesis CLIs make it: host arrays through
    ``prepare_condition`` and the eager chain of ``make_synthesis_fn``."""
    model, diffusion = _model()
    run = common.make_synthesis_fn(model, diffusion, crop_z=12, device="cpu")
    vols = _volumes()

    def request(seed=3):
        cond = common.prepare_condition(vols, "t1c", device="cpu")
        return run(cond, vols["t1n"], torch.Generator().manual_seed(seed))

    return request


@pytest.fixture(scope="module")
def train_step():
    """One batch-1 optimizer step of the tiny model on the CPU."""
    model, diffusion = _model()
    opt = train.make_optimizer(1e-4)
    state = tstate.TrainState.create(model, opt)
    step = train.make_train_step(model, diffusion, opt, contr="t1c")
    batch = {k: torch.from_numpy(v) for k, v in _volumes(1).items()}
    rng = train.StepRNG.seeded(0, "cpu")
    return lambda: step(state, batch, rng)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    """Without a profiler a span is one shared no-op context: no record
    function, no CUDA event, no synchronisation, nothing kept."""
    def refuse(*a, **kw):
        raise AssertionError("called with the profiler off")

    for owner, name in ((torch._C._profiler, "_RecordFunctionFast"),
                        (torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function"),
                        (torch.cuda, "Event"), (torch.cuda, "synchronize"),
                        (torch.cuda, "is_current_stream_capturing")):
        monkeypatch.setattr(owner, name, refuse)
    profiling.clear_spans()
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("a") is profiling.annotate("b", bytes=1)
    with profiling.annotate("cwdm.outer", steps=2):
        with profiling.annotate("cwdm.inner"):
            torch.ones(4).sum()
    timer = profiling.StepTimer()
    with timer.phase("step"):
        pass
    assert profiling.spans() == []


class _FakeEvent:
    """A CUDA event's calls, recorded."""

    log: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        self.log.append("record")

    def synchronize(self):
        self.log.append("synchronize")

    def elapsed_time(self, end):
        return 2.5


@pytest.mark.parametrize("capturing", [False, True])
def test_on_records_events_and_no_synchronisation(monkeypatch, capturing):
    """On, with CUDA in use, a span records a start and an end event on the
    stream and never synchronises; its device time is resolved when the
    store is read. While the stream captures a graph it records no event."""
    def refuse(*a, **kw):
        raise AssertionError("a span synchronised")

    _FakeEvent.log = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    profiling.clear_spans()
    with _cpu_profile():
        with profiling.annotate("cwdm.outer"):
            with profiling.annotate("cwdm.inner"):
                pass
    assert _FakeEvent.log == ([] if capturing else ["record"] * 4)
    got = profiling.spans()
    assert [s["device_ms"] for s in got] == ([None, None] if capturing else [2.5, 2.5])
    assert _FakeEvent.log == ([] if capturing else ["record"] * 4 + ["synchronize"] * 2)


def test_synthesis_span_tree(synthesize):
    """A volume under the profiler: ``cwdm.condition`` ⟶ three uploads and the
    DWT, then ``cwdm.synthesize`` ⟶ uploads, the (eager) chain, decode and
    readback, each root's spans sharing its id; the counts as given."""
    synthesize()  # the first call's lazy set-up outside the profile
    profiling.clear_spans()
    with _cpu_profile():
        synthesize()
    got = profiling.spans()
    roots = [s for s in got if s["parent"] is None]
    assert [s["name"] for s in roots] == ["cwdm.condition", "cwdm.synthesize"]
    cond, synth = roots
    assert _children(got, cond) == ["cwdm.upload"] * 3 + ["cwdm.dwt"]
    assert _children(got, synth) == (["cwdm.upload"] * 2
                                     + ["cwdm.chain", "cwdm.decode", "cwdm.readback"])
    assert all(s["root"] == r["id"] for r in roots for s in got if s["parent"] == r["id"])
    assert len(got) == 2 + 4 + 5  # no span under the chain: no graph on the CPU
    by = {s["name"]: s for s in got}
    assert by["cwdm.synthesize"]["counts"] == {"batch": 1}
    assert by["cwdm.chain"]["counts"] == {"steps": 10}
    assert by["cwdm.readback"]["counts"] == {"bytes": 16 * 16 * 16 * 4}
    uploads = [s["counts"]["bytes"] for s in got if s["name"] == "cwdm.upload"]
    assert uploads == [16**3 * 4] * 3 + [0, 16**3 * 4]  # the condition is on the device
    assert all(s["device_ms"] is None and s["end_ns"] >= s["start_ns"] for s in got)
    for s in got:
        kids = [k for k in got if k["parent"] == s["id"]]
        assert all(s["start_ns"] <= k["start_ns"] <= k["end_ns"] <= s["end_ns"] for k in kids)


def test_train_step_span_tree(train_step):
    """A train step under the profiler: ``cwdm.train.step`` ⟶ forward,
    backward, optimizer, EMA (no all-reduce without a mesh)."""
    train_step()
    profiling.clear_spans()
    with _cpu_profile():
        train_step()
    got = profiling.spans()
    (root,) = [s for s in got if s["parent"] is None]
    assert root["name"] == "cwdm.train.step" and root["counts"] == {"batch": 1}
    assert _children(got, root) == ["cwdm.train.forward", "cwdm.train.backward",
                                    "cwdm.train.optimizer", "cwdm.train.ema"]
    assert {s["root"] for s in got} == {root["id"]}


def test_span_intervals_match_the_profiler_events(synthesize, train_step):
    """Each span's host interval lies on the profiler's clock: within 50 µs
    of its record function's event in ``prof.events()``, which the trace
    shows above the operations it ran."""
    synthesize()
    train_step()
    profiling.clear_spans()
    with _cpu_profile() as prof:
        synthesize()
        train_step()
    got = profiling.spans()
    start = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("cwdm."):
            events.setdefault(e.name, []).append(e)
    assert sorted(events) == sorted({s["name"] for s in got})
    seen = {}
    for s in got:
        e = events[s["name"]][seen.setdefault(s["name"], 0)]
        seen[s["name"]] += 1
        assert abs((s["start_ns"] - start) / 1e3 - e.time_range.start) < 50.0, s
        assert abs((s["end_ns"] - start) / 1e3 - e.time_range.end) < 50.0, s
    assert seen == {k: len(v) for k, v in events.items()}
    (dwt,) = events["cwdm.dwt"]
    assert dwt.cpu_children  # the operations the span ran lie under it


# ---------------------------------------------------------------------------
# the benchmark's readers (``cwdm_bench/metrics``) of the store

READERS = ("upload_ms.synth", "readback_ms.synth", "chain_step_ms.synth",
           "forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")
SYNTH = [("cwdm.condition", [("cwdm.upload", {"bytes": 4})] * 3 + [("cwdm.dwt", {})]),
         ("cwdm.synthesize", [("cwdm.upload", {"bytes": 0}), ("cwdm.upload", {"bytes": 4}),
                              ("cwdm.chain", {"steps": 10}), ("cwdm.decode", {}),
                              ("cwdm.readback", {"bytes": 4})])]
TRAIN = [("cwdm.train.step", [("cwdm.train.forward", {}), ("cwdm.train.backward", {}),
                              ("cwdm.train.optimizer", {}), ("cwdm.train.ema", {})])]
# each reader's value where every span of the read block takes 1 ms
EXPECTED = {"upload_ms.synth": 5.0, "readback_ms.synth": 1.0, "chain_step_ms.synth": 0.1,
            "forward_host_ms.train": 1.0, "backward_host_ms.train": 1.0,
            "optimizer_host_ms.train": 2.0}


def _reader(name):
    path = REPO / "cwdm_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"spans_reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _made_up(items, n, runs=2, device=True, slow=False):
    """The store of ``runs`` benchmark runs in one process, each a traced
    block of ``n`` items on the device alone, then ``n`` with the host traced:
    every span of the last run's device-only block takes 1 ms, all others
    100 ms (so reading the wrong block shows); ``slow``: the spans of that
    block's first item take 1000 ms."""
    out, ids = [], itertools.count(1)
    for run in range(runs):
        for block in range(2):
            for i in range(n):
                ms = 1.0 if (run, block) == (runs - 1, 0) else 100.0
                ms = 1000.0 if slow and (run, block, i) == (runs - 1, 0, 0) else ms
                for root_name, children in items:
                    rid = next(ids)
                    for name, counts in [(root_name, {})] + children:
                        sid = rid if name == root_name else next(ids)
                        out.append({"name": name, "id": sid,
                                    "parent": None if sid == rid else rid, "root": rid,
                                    "host_ms": ms, "device_ms": ms if device else None,
                                    "counts": counts})
    return out


@pytest.mark.parametrize("name", READERS)
def test_readers_read_the_last_runs_device_only_block(monkeypatch, name):
    items = SYNTH if name.endswith(".synth") else TRAIN
    monkeypatch.setattr(profiling, "spans", lambda: _made_up(items, 3))
    assert _reader(name)({"trace_items": 3}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_readers_take_the_median_item(monkeypatch, name):
    """One slow item of the block (a pageable copy that stalls) does not
    set the value: the readers give the median over the block's items."""
    items = SYNTH if name.endswith(".synth") else TRAIN
    monkeypatch.setattr(profiling, "spans", lambda: _made_up(items, 3, slow=True))
    assert _reader(name)({"trace_items": 3}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_where_nothing_is_recorded(monkeypatch, name):
    """Nothing to read: fewer roots than two traced blocks, no device events
    (the CPU: device metrics only), or a program that keeps no spans."""
    items = SYNTH if name.endswith(".synth") else TRAIN
    read = _reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: _made_up(items, 3, runs=1))
    assert read({"trace_items": 4}) is None
    monkeypatch.setattr(profiling, "spans", lambda: _made_up(items, 3, device=False))
    host = name in ("upload_ms.synth",) or name.endswith(".train")
    assert (read({"trace_items": 3}) is None) is not host
    monkeypatch.delattr(profiling, "spans")
    assert read({"trace_items": 3}) is None


def test_readers_on_a_cpu_run(synthesize, train_step):
    """The store as a traced benchmark run fills it, twice in one process:
    the host readers read the second run's first block; the device readers
    give nothing on the CPU."""
    n = 3
    profiling.clear_spans()
    for _ in range(2):
        for _block in range(2):
            with _cpu_profile():
                for _ in range(n):
                    synthesize()
                    train_step()
    got = profiling.spans()
    rec = {"trace_items": n}

    def per_item(roots, names):
        # the i-th root of each name is the second run's i-th device-only item
        firsts = [[s["id"] for s in got if s["name"] == root][2 * n:3 * n] for root in roots]
        return statistics.median(
            sum(s["host_ms"] for s in got if s["root"] in item and s["name"] in names)
            for item in zip(*firsts))

    assert _reader("upload_ms.synth")(rec) == pytest.approx(
        per_item(("cwdm.condition", "cwdm.synthesize"), ("cwdm.upload",)))
    for name, part in (("forward_host_ms.train", ("cwdm.train.forward",)),
                       ("backward_host_ms.train", ("cwdm.train.backward",)),
                       ("optimizer_host_ms.train", ("cwdm.train.optimizer", "cwdm.train.ema"))):
        value = _reader(name)(rec)
        assert value == pytest.approx(per_item(("cwdm.train.step",), part)) and value > 0
    assert _reader("readback_ms.synth")(rec) is None
    assert _reader("chain_step_ms.synth")(rec) is None


@pytest.mark.cuda
def test_captured_chain_spans_on_the_card():
    """The captured chain under an active profiler: a span entered inside
    the captured step records no event there (the warm-up steps' do), the
    chain's span holds them all and has device time, and the volume equals
    the one made without the profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA graph has no CPU mode)")
    model, diffusion = _model("cuda")

    class Marked(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, t):
            with profiling.annotate("test.model"):
                return self.inner(x, t)

    vols = _volumes()
    cond = common.prepare_condition(vols, "t1c", device="cuda")
    volumes = []
    for traced in (True, False):
        run = common.make_synthesis_fn(Marked(model), diffusion, crop_z=12, device="cuda")
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced \
                else contextlib.nullcontext():
            volumes.append(run(cond, vols["t1n"], torch.Generator(device="cuda").manual_seed(3)))
        torch.cuda.synchronize()
        got = profiling.spans()
        if traced:
            (chain,) = [s for s in got if s["name"] == "cwdm.chain"]
            assert chain["counts"] == {"steps": diffusion.num_timesteps}
            marked = [s for s in got if s["name"] == "test.model"]
            assert len(marked) == 3  # two warm-up steps and the capture; replays run no Python
            assert [s["device_ms"] is None for s in marked] == [False, False, True]
            assert all(s["parent"] == chain["id"] for s in marked)
            assert chain["device_ms"] >= sum(s["device_ms"] for s in marked[:2]) > 0
            assert [s["name"] for s in got if s["parent"] == chain["id"]] == ["test.model"] * 3
        else:
            assert got == []
    assert np.array_equal(volumes[0], volumes[1])
