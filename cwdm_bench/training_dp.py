"""The driver of data-parallel training mixes (``"kind": "training_dp"``).

``training.py``'s optimizer steps on the program's data axis
(``parallel/mesh.py``): ``ranks`` processes, one card each, NCCL between
cards (gloo on the CPU), batch ``batch`` a rank. Rank 0 is the harness's
process; it starts ranks 1.. as ``python -m cwdm_bench.training_dp`` with
the run written to a file beside them, and waits for them at the end.

Every rank builds the same seeded weights, train state and case pool, and
each step feeds ``make_train_step(..., mesh=)`` its own rows of the seeded
global batch (rank r takes rows [r·batch, (r+1)·batch) of ``ranks ×
batch``), with the global batch's t and noise as ``training.Feed`` draws
them at that size. The first ``check_steps`` steps are set-up and are held
against the plain reference at the global batch (each sample's gradient
taken alone and averaged, as the data axis averages them), by
``training.py``'s numbers. Then the window: steps back to back on rank 0's
clock. So that every rank stops at the same step, each step ends with an
all-reduce (max) of a one-element stop flag that rank 0 raises when its
window has passed; a rank reads the flag of the step ``FLAG_LAG`` steps
back, long finished, so the host is not held to the card. With ``--trace
1`` every rank runs 2 × ``trace_items`` steps more under the profiler, in
the same traced blocks (``devtrace.traced``), so that tracing slows every
rank alike; each rank reports the device ms of its ``cwdm.train.allreduce``
spans a step (``allreduce_ms_by_rank``, read by ``allreduce_ms.dp``). At
the end the ranks compare their parameters with rank 0's (``rank_gap``: the
largest difference, limit 0) and report their memory peaks: the run's
``memory_peak_bytes`` is the fullest rank's.

A rank that dies or hangs ends the run: the process group's collectives
give up after ``RANK_TIMEOUT_S`` (gloo raises, and rank 0 reports the run
failed and not correct; NCCL's watchdog ends the process), rank 0 kills
every rank still running when it returns or fails, and a rank whose parent
dies is killed with it.

Traffic keys: ``training.py``'s and ``ranks``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import datetime
import gc
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from cwdm_bench import devtrace, harness, spans, training
from cwdm_bench.reference import cwdm

TRACED = training.TRACED
ALLREDUCE_SPAN = "cwdm.train.allreduce"
RANK_TIMEOUT_S = 120  # a collective, the group's start, or a rank's exit after rank 0's
FLAG_LAG = 2  # steps between a stop flag's all-reduce and its read


def global_batch(run: harness.Run) -> harness.Run:
    """``run`` with its traffic's batch the global batch, ``ranks × batch``."""
    return dataclasses.replace(run, traffic={
        **run.traffic, "batch": int(run.traffic["batch"]) * int(run.traffic["ranks"])})


class RankFeed(training.Feed):
    """``training.Feed`` at the global batch, giving this rank's rows of the
    cases and the global batch's t and noise (the same draws as
    ``training.Feed`` at that batch)."""

    def __init__(self, run: harness.Run, n_steps: int, rank: int):
        super().__init__(global_batch(run), n_steps)
        per_rank = int(run.traffic["batch"])
        self.rows = range(rank * per_rank, (rank + 1) * per_rank)

    def __call__(self, i: int):
        picks = [self.pool[self.order[(i * self.batch + b) % len(self.pool)]] for b in self.rows]
        batch = (picks[0] if len(picks) == 1 else
                 {m: torch.cat([p[m] for p in picks]) for m in picks[0]})
        g = torch.Generator(device=self.run.device).manual_seed(
            harness.sub_seed(self.run.seed, "step", i))
        t = torch.randint(0, self.n_steps, (self.batch,), generator=g, device=self.run.device)
        shape = (self.batch, *batch[cwdm.MODALITIES[0]].shape[1:])
        noise = torch.randn(shape, generator=g, device=self.run.device)
        return batch, t, noise


class StopFlags:
    """The window's stop flag: ``push(stop)`` all-reduces (max) this step's
    flag, ``stopped()`` reads the one pushed ``FLAG_LAG`` steps back (False
    until there is one), the same value on every rank."""

    def __init__(self, dev: torch.device):
        self.dev, self.pending = dev, collections.deque()

    def push(self, stop: bool) -> None:
        f = torch.full((1,), int(stop), dtype=torch.int32, device=self.dev)
        dist.all_reduce(f, op=dist.ReduceOp.MAX)
        if self.dev.type == "cuda":
            host = torch.empty(1, dtype=torch.int32, pin_memory=True)
            host.copy_(f, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self.pending.append((host, done))
        else:
            self.pending.append((f, None))

    def stopped(self) -> bool:
        if len(self.pending) <= FLAG_LAG:
            return False
        host, done = self.pending.popleft()
        if done is not None:
            done.synchronize()
        return bool(host[0])


def _max_over_ranks(value: float, dev: torch.device) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def allreduce_ms(n: int) -> list[float]:
    """This rank's device ms of its ``cwdm.train.allreduce`` spans in each of
    the traced block's ``n`` device-only steps (``spans.py``); NaN for a step
    without them, or without device events (the CPU)."""
    out = []
    for item in spans.device_items({"trace_items": n}, ("cwdm.train.step",)) or [[]] * n:
        values = [s["device_ms"] for s in item if s["name"] == ALLREDUCE_SPAN]
        out.append(math.nan if not values or None in values else sum(values))
    return out


def allreduce_ms_by_rank(n: int, ranks: int, dev: torch.device) -> list[list[float]] | None:
    """``allreduce_ms`` of every rank, one row a rank (a collective); None
    where any rank lacks a step (a program without the span)."""
    mine = torch.tensor(allreduce_ms(n), dtype=torch.float64, device=dev)
    rows = [torch.empty_like(mine) for _ in range(ranks)]
    dist.all_gather(rows, mine)
    rows = [r.tolist() for r in rows]
    return None if any(math.isnan(v) for r in rows for v in r) else rows


def rank_gap(params: dict, dev: torch.device) -> float:
    """The largest |p − p on rank 0| over every parameter and rank."""
    flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    gap = float((flat - ref).abs().max())
    del flat, ref
    return _max_over_ranks(gap, dev)


def rank_main(run: harness.Run, rank: int, ranks: int, port: int) -> dict | None:
    """One rank's share of the run: join the group, build, the checked
    steps, the window, the traced block, the end's comparison. Rank 0
    returns its record (without ``readings`` and ``device``)."""
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.parallel import mesh as pmesh
    from fast_cwdm_tpu_torch.training import state as tstate
    from fast_cwdm_tpu_torch.training import train

    cfg, tr, dev = run.config, run.traffic, run.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        mesh = pmesh.make_mesh()
        opt_cfg = cfg["training"]
        model_cfg = training.model_config(cfg)
        model, diffusion = harness.build_program(model_cfg, run.seed, dev)
        opt = train.make_optimizer(opt_cfg["lr"], weight_decay=opt_cfg["weight_decay"],
                                   lr_anneal_steps=opt_cfg["lr_anneal_steps"])
        state = tstate.TrainState.create(model, opt, ema_rates=(opt_cfg["ema_rate"],))
        step = train.make_train_step(model, diffusion, opt, contr=tr["contr"], mesh=mesh)
        run.part("weights_and_state")
        feed = RankFeed(run, diffusion.num_timesteps, rank)
        run.part("cases")

        def one(i: int) -> dict:
            batch, t, noise = feed(i)
            return step(state, batch, t=t, noise_img=noise)[1]

        n_check = int(tr["check_steps"])
        p0 = {k: v.detach().clone() for k, v in state.params.items()}
        losses, grad1 = [], None
        before = ops.launch_counts()
        for i in range(n_check):
            metrics = one(i)
            losses.append(metrics["loss"])
            if i == 0:
                launched = ops.launches_since(before)
                grad1 = {k: torch.linalg.vector_norm(v) / (1.0 - opt.b1)
                         for k, v in state.opt_state["mu"].items()}
        change = training._norms({k: p.detach() - p0[k] for k, p in state.params.items()})
        ema = training._norms({k: e - p0[k] for k, e in state.ema_params[0].items()})
        program = {"loss": [float(v) for v in losses], "grad1": training._host(grad1),
                   "change": training._host(change), "ema": training._host(ema)}
        del p0
        run.part("checked_steps")
        dist.barrier()
        setup_s = time.perf_counter() - run.t_start
        if rank == 0:
            harness.log(setup_s=setup_s, setup=run.setup, launches_per_step=launched)

        bad = torch.zeros((), dtype=torch.int64, device=dev)
        flags = StopFlags(dev)
        harness.reset_peak(dev)
        ends = []
        with harness.HostLoad() as host:
            t0 = time.perf_counter()
            i = n_check
            while True:
                metrics = one(i)
                bad += (~torch.isfinite(metrics["loss"])).to(torch.int64)
                i += 1
                ends.append(time.perf_counter())
                flags.push(rank == 0 and ends[-1] - t0 >= run.seconds)
                if flags.stopped():
                    break
            harness.sync(dev)
            window_s = time.perf_counter() - t0
        steps = i - n_check
        if rank == 0:
            harness.log(window_host=host.summary, step_s_by_10s=harness.slice_rates(ends, t0))

        rec = {"config": cfg, "model": model_cfg, "traffic": tr, "setup_s": setup_s,
               "window_s": window_s, "items": steps, "batch": len(feed.rows),
               "ranks": ranks, "forwards_per_item": 1,
               "latent": tuple(s // 2 for s in feed.pool[0]["t1n"].shape[1:4]),
               "trace": None, "spans": {}, "attempted": steps, "failed": int(bad),
               "program": program}
        if run.trace:
            n = int(tr["trace_items"])

            def work(j: int) -> None:
                with torch.profiler.record_function("bench.step"):
                    one(TRACED + j)

            summary = devtrace.traced(work, n, ops.launch_counts, ops.launches_since, dev,
                                      timers=harness.wavelet_timers(run) if rank == 0 else None)
            by_rank = allreduce_ms_by_rank(n, ranks, dev)
            if rank == 0:
                harness.log(trace_window_s=summary["window_s"], busy_s=summary["busy_s"],
                            records_missing=summary["records_missing"],
                            launched=summary["launched"], filled=summary["filled"],
                            allreduce_ms_by_rank=by_rank)
                rec.update(trace=summary, trace_items=n, allreduce_ms_by_rank=by_rank)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        rec["memory_peak_bytes"] = int(_max_over_ranks(peak, dev))
        rec["rank_gap"] = rank_gap(state.params, dev)
        del state, step, model, opt, metrics
        return rec if rank == 0 else None
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(run: harness.Run, ranks: int, port: int, workdir: str) -> list:
    """Ranks 1.. as child processes, each with its log file in ``workdir``."""
    spec = os.path.join(workdir, "run.json")
    with open(spec, "w") as f:
        json.dump({"seed": run.seed, "seconds": run.seconds, "trace": run.trace,
                   "device": run.device.type, "config": run.config, "traffic": run.traffic,
                   "limits": run.limits}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(harness.ROOT), env.get("PYTHONPATH")) if p)
    procs = []
    for r in range(1, ranks):
        with open(os.path.join(workdir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cwdm_bench.training_dp", "--spec", spec, "--rank",
                 str(r), "--ranks", str(ranks), "--port", str(port),
                 "--parent", str(os.getpid())],
                cwd=harness.ROOT, env=env, stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def stop_ranks(procs: list, workdir: str, timeout: float) -> list[int | None]:
    """Each rank's exit code once it has ended, waiting ``timeout`` seconds in
    all; a rank still running then is killed (None). The log tail of a rank
    that failed goes to standard error."""
    deadline, codes = time.monotonic() + timeout, []
    for r, p in enumerate(procs, start=1):
        try:
            codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
        if codes[-1] != 0:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                harness.log(rank=r, exit=codes[-1], log_tail=f.read()[-3000:])
    return codes


def run(run: harness.Run) -> dict:
    cfg, tr = run.config, run.traffic
    ranks = int(tr["ranks"])
    dev = torch.device(run.device.type, 0) if run.device.type == "cuda" else run.device
    run = dataclasses.replace(run, device=dev)
    run.part("import")
    if dev.type == "cuda":
        from fast_cwdm_tpu_torch.ops import _build

        _build.build()
    run.part("build")
    workdir, port = tempfile.mkdtemp(prefix="cwdm_bench_dp_"), free_port()
    procs = start_ranks(run, ranks, port, workdir)
    rec, codes = None, []
    try:
        try:
            rec = rank_main(run, 0, ranks, port)
        except RuntimeError as e:  # a collective with a rank that died or hung
            harness.log(rank_failure=repr(e)[-2000:])
        codes = stop_ranks(procs, workdir, RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    if rec is None or any(c != 0 for c in codes):
        return failed_record(run, ranks, rec)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["device"] = {**harness.device_record(dev, 1), "count": ranks,
                     "memory_peak_bytes": rec.pop("memory_peak_bytes")}
    ref = reference_readings(run, training.model_config(cfg), int(tr["check_steps"]), "fp32")
    rec["readings"] = {**training.compare(rec.pop("program"), ref),
                       "rank_gap": rec.pop("rank_gap")}
    return rec


def failed_record(run: harness.Run, ranks: int, rec: dict | None) -> dict:
    """The record of a run in which a rank failed: one step, failed, and
    every reading infinite, so that the run is not correct; its times are
    the seconds from the start to the failure and mean nothing more."""
    elapsed = time.perf_counter() - run.t_start
    return {"config": run.config, "model": training.model_config(run.config),
            "traffic": run.traffic, "setup_s": elapsed, "window_s": elapsed, "items": 1,
            "batch": int(run.traffic["batch"]), "ranks": ranks, "forwards_per_item": 1,
            "trace": None, "spans": {}, "attempted": max(1, (rec or {}).get("attempted", 0)),
            "failed": max(1, (rec or {}).get("attempted", 0)),
            "device": {**harness.device_record(run.device, 1), "count": ranks},
            "readings": {k: math.inf for k in run.limits}}


def reference_readings(run: harness.Run, model_cfg: dict, n_steps: int, prec: str) -> dict:
    """The reference's losses, first gradient and changes over the first
    ``n_steps`` steps at the global batch, in ``prec``: each sample's loss
    and gradient taken alone and averaged (the batch's loss is the mean of
    its samples')."""
    feed = training.Feed(global_batch(run), int(run.config["model"]["diffusion_steps"]))
    opt_cfg = run.config["training"]
    init = harness.draw_weights(cwdm.param_shapes(model_cfg), run.seed, run.device)
    p = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    opt = cwdm.AdamW(p, opt_cfg["lr"], opt_cfg["lr_anneal_steps"], opt_cfg["ema_rate"],
                     weight_decay=opt_cfg["weight_decay"])
    losses, grad1 = [], None
    for i in range(n_steps):
        batch, t, noise = feed(i)
        total, grads = 0.0, {k: torch.zeros_like(v) for k, v in p.items()}
        for b in range(feed.batch):
            row = {m: v[b:b + 1] for m, v in batch.items()}
            loss = cwdm.loss(p, model_cfg, row, t[b:b + 1], noise[b:b + 1],
                             run.traffic["contr"], prec)
            for k, g in zip(p, torch.autograd.grad(loss, list(p.values()))):
                grads[k] += g
            total += float(loss.detach())
            del loss
        grads = {k: g / feed.batch for k, g in grads.items()}
        losses.append(total / feed.batch)
        if i == 0:
            grad1 = training._host(training._norms(grads))
        opt.step(p, grads)
        del grads
    with torch.no_grad():
        change = training._host(training._norms({k: v - init[k] for k, v in p.items()}))
        ema = training._host(training._norms({k: v - init[k] for k, v in opt.ema.items()}))
    return {"loss": losses, "grad1": grad1, "change": change, "ema": ema}


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent (rank 0) ends
    (Linux's PR_SET_PDEATHSIG; elsewhere nothing)."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl.argtypes = [ctypes.c_int, ctypes.c_ulong]
        libc.prctl.restype = ctypes.c_int
        libc.prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:  # the parent ended before the call
        os._exit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank (1..) of a training_dp run")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--parent", type=int, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    t_start = time.perf_counter()
    with open(args.spec) as f:
        spec = json.load(f)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = \
        spec["config"]["precision"]["tf32"]
    dev = (torch.device("cuda", args.rank) if spec["device"] == "cuda"
           else torch.device(spec["device"]))
    run = harness.Run(spec["seed"], spec["seconds"], spec["trace"], dev, spec["config"],
                      spec["traffic"], spec["limits"], t_start)
    rank_main(run, args.rank, args.ranks, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
