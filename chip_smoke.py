#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase (what a release check runs)
    python3 chip_smoke.py --profile  # also trace one forward and one train step of each kind

Phases, each printing one JSON object per line:

1. device   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build    — compile the hand-written kernels (``ops/csrc/*.cu``) with nvcc;
3. kernels  — each kernel against its plain PyTorch version at the shapes
              of the production path, with its time, the plain version's,
              one library call's where one computes the same function, and
              the least time the card could take (bytes or operations);
              the fused conv (K4a/K4b/K5) on each of its kernels that
              takes the shape (wgmma at 64 and at 32 output channels a
              block, split-K, the fp32 3×TF32 wgmma kernel, mma.sync) at
              fifteen bf16 shapes, the tp axis's six Co/2 shapes among
              them, and at the seventeen fp32 shapes of FP32_CONV_SHAPES
              (every production shape, and B = 2), with the tolerance
              ratio (≤ 1 passes; the 3×TF32 kernel ≤ TF32_TOL_RATIO, 0.1),
              differing elements and two launches bit
              for bit; the kernels, cuDNN and the bound at every distinct
              conv shape of the forward (in bf16 and in fp32, there beside
              cuDNN's fp32 with TF32 off, the plain version and the FFMA
              bound) and at the six Co/2 shapes; how the 3×TF32 kernel's
              split rounds and how its tensor cores read fp32;
4. forward  — the 81,511,048-parameter production UNet in bf16 at
              (1, 112, 112, 80, 32): unfused, fuse_gn_silu (K3) and
              fuse_conv (K4b), timed in turns; with ``--profile`` the
              device time by kernel; then in fp32 with fuse_conv (every
              conv on the 3×TF32 kernel) against the unfused fp32 forward
              (1e-4 of the output's scale), its launches by kernel and
              device ms by kind, beside the same forward with every fused
              conv on conv3d.cu's FFMA path;
5. synthesis— the ``fast_cwdm_tpu_torch.cli.sample`` entry point on one
              synthetic 240×240×155 BraTS case with seeded weights, 10-step
              sampled schedule, twice: every GN→SiLU through K3 (ddpm),
              then every ResBlock conv through K4b (dpm++, 10 evaluations,
              as ``bench.py --fused --dpm 10``); the launch counts of each
              run, by entry point and by kernel (levels 0-2 on wgmma,
              3-4 on split-K, by ``conv3d_cuda.route``), and that each
              went through the captured CUDA graph chain (one capture,
              eight replays); then ``make_synthesis_fn`` of eight variants,
              each eager (``cuda_graph=False``) and graphed, in turns: the
              images of the two paths (bit for bit expected), launches per
              volume, capture seconds and graph pool memory; two of them
              are ``bench.py``'s faithful leg (fp32, unfused, TF32 off,
              cuDNN deterministic, ``diffusion.replace(
              fuse_clip_projection=False)``: the reference's IDWT → clamp
              → DWT every step, one K2 and one K1 a step, K1 13 and K2 11
              a volume, eager and graphed bit for bit) and the same chain
              with the fused projection (the images within 1e-4), and that
              chain with fuse_conv in fp32 (540 K4b a volume by route, its
              image within 1e-4 of the unfused fp32 one), once on the
              3×TF32 kernel and once on conv3d.cu's FFMA path; a ``devtime``
              trace of the fuse_conv dpm++ synthesis on each path (device
              ms, wall ms, busy share); a 100-step fuse_conv ddpm chain,
              graphed, with ``chunk`` None and 32, equal bit for bit;
6. completion— the production weights written as a JAX-layout ``.ckpt``
              (with one EMA shadow and a sidecar as the JAX package writes
              it) and read back bit for bit, its size and seconds; then
              ``fast_cwdm_tpu_torch.cli.complete_dataset`` on two
              240×240×155 cases without t1c and one complete case: (a) the
              sidecar as written (unfused ddpm: 3 K1 + 1 K2 per case), (b)
              ``fuse_conv`` added to the sidecar with ``--sampler dpm++
              --sampling_steps 10`` (540 K4b per case: 300 wgmma, 240
              split-K); then ``cli.sample_auto`` on the same tree; every
              output checked (geometry, affine, [0,1], brain mask, border,
              pass-through), each run through the captured chain, and the
              seconds per case;
7. orbax    — the main path from the JAX package's ``.orbax`` backend
              (``training/orbax_io.py``, no Orbax): the same weights written
              by the port as an Orbax directory and read back bit for bit
              (bytes and seconds beside the ``.ckpt``'s); the committed
              tensorstore-written fixtures ``tests/golden/*.orbax`` equal
              to their ``.npz``; ``cli.complete_dataset`` from the
              ``.orbax`` with ``fuse_conv`` and dpm++ 10 (the images of
              completion's run (b) by sha256; 540 K4b per case); then
              ``cli.train --fuse_gn_silu=True`` under
              ``FAST_CWDM_CKPT_BACKEND=orbax`` (3 steps, every file an Orbax
              directory) and one step resumed from its step checkpoint
              (the ``.orbax`` opt blob named, the state restored bit for
              bit; K1 5, K2 1, K3 83, VJP 71 per step);
8. training — the K3 VJP kernel against its plain version at every
              distinct GN+SiLU shape of the production UNet (bf16
              channels_last_3d and fp32 contiguous; gx bit for bit, ga and
              gb within 1e-5 of the sum of the terms' magnitudes, two
              launches bit for bit), its time per shape and per train step;
              then ``fast_cwdm_tpu_torch.cli.train`` with ``run.sh``'s TRAIN
              flags (batch 1, lr 1e-5, use_checkpoint) on two synthetic
              240×240×155 cases at the production config, a few steps each
              and a BEST: (a) unfused, (b) ``--fuse_gn_silu=True`` (K3 and
              its VJP); warm s/step, peak memory, the loss of every step,
              parameters moved, launches per step; (a) again without
              use_checkpoint for its peak memory; a fuse_conv model under
              backward still raises; then ``cli.complete_dataset`` from (a)'s
              BEST on a case without t1c, output checked;
9. reference— the whole synthesis at a tiny fp32 config on the card,
              graphed and eager, against the same on the CPU (plain
              versions), same noise: fuse_gn_silu under ddpm,
              fuse_conv under ddpm, ddim and dpm++, and the unfused model
              under ddpm with ``fuse_clip_projection=False`` (K1 13, K2 11);
10. evaluation— the BraSyn evaluation chain at full size through the
              port's entry points: ``scripts.quality_bench`` stage gen (2
              train and 4 val 240×240×155 phantoms), ``run.sh --mode
              train`` (4 steps: K1 5, K2 1 per step), stage eval (copy
              rows equal to QUALITY_r04.json's within 1e-9; a 4-step
              model's rows, finite), ``cli.drop_modality``, ``run.sh
              --mode complete`` as written (3 K1 + 1 K2 per case) and with
              fuse_conv + dpm++ 10 (540 K4b per case: 300 wgmma, 240
              split-K), ``cli.prepare_nnunet_dataset``, ``run.sh --mode
              sample`` + ``cli.evaluate_synthesis`` on the card,
              ``scripts.downstream_bench`` (real leg and GT region means
              equal to the JAX records within 1e-12), and ``ssim3d`` /
              ``psnr`` on the card against the CPU (≤ 1e-10) with both
              times;
11. probes  — on evaluation's trees and BEST, at production width: the
              native decoder (built, every val volume bit for bit the numpy
              float32 path, ms per case of it, of that path and of the
              float64 reader, ``ThreadedLoader`` cases/s with it and under
              ``FAST_CWDM_NATIVE=0``, its decode count, the decode's share
              of ``evaluate_cases``); then each ported probe through its
              ``main``: ``probe_elementwise`` (A, B, C), ``probe_lane_ceiling``
              (cuDNN and K4b at six channel pairs, K4b at the new shapes
              against plain, the fold), ``probe_batch2`` (four legs, all
              complete), ``probe_core_inference`` (GT rows equal to
              PROBE_core_inference_r05.json's within 1e-6) and
              ``probe_regression`` (4 steps, completion, downstream chain);
              the K1/K2/K3/K4b launches of each;
12. models  — the rest of the network surface: (a) ``cli.train`` with
              run.sh's flags and ``--use_freq=True --channel_mult=1,2,2,4``
              (the 54,285,640-parameter WavUNet) on two 240×240×155
              cases, 3 steps and a BEST (K1 5, K2 1 per step), then
              ``cli.sample`` from that BEST with run.sh's COMMON flags
              (the sidecar brings use_freq back; 3 K1 + 1 K2, the
              captured chain), ``make_synthesis_fn`` eager against
              graphed (bit for bit) and the device ms of its plain
              multi-channel Haar transforms in a forward; (b) the
              production UNet with attention at ds 8 and 16 and in the
              bottleneck (4 heads), seeded weights written as a
              JAX-layout ``.ckpt`` and read back bit for bit,
              ``cli.sample`` unfused ddpm and ``fuse_conv`` dpm++ 10 (540
              K4b: 300 wgmma, 240 split-K), eager against graphed for
              both, ms/forward beside the production forward's; (c) every
              new module at a tiny fp32 size (attention in both head
              orders and with num_head_channels, class-conditional UNet
              and WavUNet, the WavUNet's double run, the encoder's three
              pools, SuperResModel, both gating blocks) on the card
              against the CPU (≤ 1e-4, TF32 off);
13. diffusion_api — the rest of ``GaussianDiffusion`` at the production
              config (bf16, fuse_conv, 10-step schedule): sample_known, the
              ancestral interpolation, ddim_sample_loop_known, a
              ddim_reverse_sample round trip, calc_bpd_loop (59 forwards,
              3,186 K4b launches), each progressive generator against its
              loop bit for bit; then the same methods at a tiny fp32 size,
              card against CPU on the same draws (≤ 1e-4, TF32 off);
14. distributed — the data axis through ``torch.distributed.run``,
              every rank reading the seeded weights from one ``.ckpt`` the
              script writes once for phases 14-16: one gloo job of two
              ranks sharing the card runs (b) then (c) in each rank,
              beside this process's one-process runs of (b), then (a)
              ``cli.train`` as one NCCL rank (bf16, fuse_gn_silu, 2
              steps) beside the rest: (b) fp32, TF32 off, cuDNN
              deterministic, global batch 2, 2 steps, against one process
              accumulating the same rows (bit for bit) and one process at
              batch 2
              (losses within 2e-5; Adam's moments and parameters
              reported); (c) ``make_synthesis_fn(mesh=)``, each row bit for
              bit its batch-1 synthesis, the difference from a batch-2
              synthesis reported; per run and rank the launches, s/step,
              the all-reduce's ms and bytes, peak memory and which rank
              wrote files;
15. spatial — the sp axis: one gloo job of two ranks as one sp group on
              the card, each with its Y slab: (a) the fp32 production
              forward (TF32 off) against one process (1e-4 of the output's
              scale); (b) the bf16 fuse_conv forward (within twice bf16's
              own error), the K4b launches by route a rank, and every
              fused-conv shape the halo-extended slabs reach on its routed
              kernel against the plain version; (c) make_synthesis_fn's
              fuse_conv dpm++ 10, eager, one call (K1 3, K2 1, K4b 540 a
              rank; the image finite, in [0,1], zero outside the mask; its
              difference from the unsharded synthesis reported), s/volume,
              halo and reduction bytes and ms a forward; (d) ``cli.train
              --spatial_mesh 2 --fuse_gn_silu True``, 3 steps (K1 5, K2 1,
              K3 83, VJP 71 a step a rank; s/step, memory, halo and
              all-reduce bytes and ms), and one fp32 step against one
              process (losses within 1e-6, Adam's first moment within 1e-3
              of its scale; the parameters reported); K1, K2, K3 and the K3
              VJP on the sp slabs' shapes against their plain versions;
16. tensor  — the tp axis: one gloo job of two ranks as one tp group on
              the card, started beside phase spatial (the times of both
              are taken under each other's load), each holding its
              slices of the parameters
              ``param_spec`` shards (40,780,680 of 81,511,048): (a) the
              fp32 forward against one process (1e-4 of the output's
              scale); (b) the bf16 fuse_conv forward (within twice bf16's
              own error), 54 K4b a rank by route (none on mma.sync: level
              0's Co 32 and level 2's Co 64 on the 32-wide wgmma kernel),
              every Co/2 shape on its routed kernel against the plain
              version, timed beside cuDNN and the bound; (c)
              make_synthesis_fn's fuse_conv dpm++ at 3 evaluations, eager
              (K1 3, K2 1, K4b 54 an evaluation a rank, none on mma.sync;
              the same finite [0,1] image on both ranks, zero outside the
              mask; its difference from the unsharded one of 3
              evaluations, s/volume, the tp gathers' bytes, ms and calls a
              forward); (d) one fp32 step of ``cli.train
              --tensor_mesh 2 --fuse_gn_silu True`` against phase
              spatial's one process (losses within 1e-6, Adam's first
              moment within 1e-3 of its scale, replicated parameters the
              same bits on both ranks; its BEST and optimizer blob are the
              bytes one process writes for the ranks' slices concatenated,
              and load into one process bit for bit; K1 5, K2 1, K3 83,
              VJP 71 a step; s/step, peak memory a rank beside one
              process's, the tp collectives' bytes and ms). Each torchrun
              job's ``cold_start_s`` (launch until its last rank is past
              set-up) is printed after the phase.

What runs beside what: phase evaluation, and then phase probes'
``probe_core_inference`` and ``probe_regression`` on its BEST, run in a
child process of this script (``--evaluation-job``, at a lower CPU priority),
started after phase synthesis, beside phases completion to diffusion_api;
phase distributed's two torchrun jobs start at phase models, phases
spatial's and tensor's at phase distributed, each rank setting itself up
and then waiting for its phase (``gated``), so that their cold starts run
beside earlier phases. The host-clock times of those phases are taken
under that load; phases kernels, forward and synthesis run alone, and
phase probes' device-timed probes beside no other work. The phases print
in the order 1-9, 12, 13, 10, 11, 14-16. Each phase prints its start
(``phase_start``: the host's load average and this process's live
descendants) and, after the torchrun jobs' line, ``{"phase_seconds":
{...}, "total": ...}``: the seconds of each phase in this process, build
excluded from ``total``.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and, last,
``{"ok": true, "device": {...}}``. Any failed phase exits nonzero before
the last line. Exits nonzero without a result when no CUDA device is
present or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM TF32 dense tensor cores
VOLUME = (224, 224, 160)
LATENT = (112, 112, 80)
# (channels, spatial) of the production UNet's levels where GN→SiLU runs
K3_SHAPES = ((64, (112, 112, 80)), (128, (56, 56, 40)), (256, (14, 14, 10)))
# (label, B, Ci, (X, Y, Z), Co) of the fused ResBlock convs checked against
# the plain version, bf16
CONV_SHAPES = (
    ("level 0", 1, 64, (112, 112, 80), 64),
    ("level 0 decoder concat", 1, 128, (112, 112, 80), 64),
    ("level 0 decoder concat 192", 1, 192, (112, 112, 80), 64),
    ("level 1", 1, 128, (56, 56, 40), 128),
    ("level 3", 1, 256, (14, 14, 10), 256),
    ("level 4, 7×7×5", 1, 256, (7, 7, 5), 256),
    ("level 4 decoder concat, X = 7", 1, 512, (7, 7, 5), 256),
    ("B = 2, per-(B, C) statistics", 2, 128, (28, 28, 20), 128),
    ("Ci = 8 mod 16", 1, 24, (20, 20, 12), 64),
    # the tp axis's Co/2 convs (tp 2) that route() gives the 32-wide wgmma
    # kernel: level 0 off the 64-wide grid, level 2 short of blocks at 64
    ("tp level 0, Co/2", 1, 64, (112, 112, 80), 32),
    ("tp level 0 decoder concat, Co/2", 1, 128, (112, 112, 80), 32),
    ("tp level 0 decoder concat 192, Co/2", 1, 192, (112, 112, 80), 32),
    ("tp level 2, Co/2", 1, 128, (28, 28, 20), 64),
    ("tp level 2 decoder concat, Co/2", 1, 256, (28, 28, 20), 64),
    ("tp level 2 decoder concat 384, Co/2", 1, 384, (28, 28, 20), 64),
)
CONV_TOL = "1 ulp of plain in the output dtype + 2^-16 conv(|act|, |w|)"
# ((X, Y, Z), Ci, Co): launches per forward) of every fused conv of the
# production UNet with fuse_conv (54 per forward)
PRODUCTION_CONVS = {
    ((112, 112, 80), 64, 64): 7, ((112, 112, 80), 128, 64): 2, ((112, 112, 80), 192, 64): 1,
    ((56, 56, 40), 64, 128): 1, ((56, 56, 40), 128, 128): 6, ((56, 56, 40), 192, 128): 1,
    ((56, 56, 40), 256, 128): 2,
    ((28, 28, 20), 128, 128): 7, ((28, 28, 20), 256, 128): 2, ((28, 28, 20), 384, 128): 1,
    ((14, 14, 10), 128, 256): 1, ((14, 14, 10), 256, 256): 6, ((14, 14, 10), 384, 256): 1,
    ((14, 14, 10), 512, 256): 2,
    ((7, 7, 5), 256, 256): 11, ((7, 7, 5), 512, 256): 3,
}
# the same of the six Co/2 convs a rank computes at tp 2 that leave the
# mma.sync kernel (20 of its 54 a forward)
TP_N32_CONVS = {
    ((112, 112, 80), 64, 32): 7, ((112, 112, 80), 128, 32): 2, ((112, 112, 80), 192, 32): 1,
    ((28, 28, 20), 128, 64): 7, ((28, 28, 20), 256, 64): 2, ((28, 28, 20), 384, 64): 1,
}
CONV_KERNELS = ("wgmma", "wgmma_n32", "splitk", "wgmma_tf32", "mma_sync")  # conv3d_cuda's routes
# the fp32 fused convs checked against the plain version on each kernel
# that takes them: every production shape (route() gives each the 3×TF32
# kernel), and B = 2 at level 1
FP32_CONV_SHAPES = tuple(
    (f"fp32 {'x'.join(map(str, sp))} {ci}→{co}", 1, ci, sp, co)
    for (sp, ci, co) in PRODUCTION_CONVS) + (
    ("fp32 B = 2, per-(B, C) statistics", 2, 128, (56, 56, 40), 128),)


PHASE_SECONDS: dict = {}  # each emitted phase's seconds, in order


def emit(rec: dict) -> None:
    if "phase" in rec and "seconds" in rec:
        PHASE_SECONDS[rec["phase"]] = rec["seconds"]
    print(json.dumps(rec), flush=True)


def descendants(root: int) -> set:
    """The live processes descended from ``root`` (``/proc``), in whatever
    session each runs."""
    parent = {}
    for pid in os.listdir("/proc"):
        if pid.isdigit():
            try:
                with open(f"/proc/{pid}/stat") as f:
                    parent[int(pid)] = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    tree, grew = {root}, True
    while grew:
        more = {pid for pid, ppid in parent.items() if ppid in tree} - tree
        tree |= more
        grew = bool(more)
    return tree - {root}


def kill_tree(proc) -> None:
    """SIGKILL a child started in a session of its own, its group and every
    process descended from it (torchrun starts each rank in a session of
    its own)."""
    if proc.poll() is None:
        for pid in descendants(proc.pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def live_children() -> int:
    """Processes descended from this one that are alive now."""
    return len(descendants(os.getpid()))


def phase_start(name: str) -> float:
    """Print the host's load and this process's live children as a phase
    starts; return the phase's start on the host clock."""
    emit({"phase_start": name, "loadavg": os.getloadavg(), "live_children": live_children()})
    return time.perf_counter()


def fail(msg: str) -> None:
    raise RuntimeError(msg)


class no_tf32:
    """cuDNN and cuBLAS in full fp32 inside the block (and, with
    ``deterministic``, cuDNN restricted to its deterministic algorithms:
    no atomic-add reductions in the weight gradients), each flag restored
    after it (cuDNN's default is TF32 on, cuBLAS's off)."""

    def __init__(self, torch, deterministic: bool = False):
        self.b, self.det = torch.backends, deterministic

    def __enter__(self):
        b = self.b
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
        b.cudnn.deterministic = self.det or b.cudnn.deterministic

    def __exit__(self, *exc):
        b = self.b
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic = self.saved


@contextlib.contextmanager
def fp32_on_conv3d_cu(torch, tc):
    """``conv3d_cuda.route`` with every fp32 conv sent to ``conv3d.cu``'s
    FFMA path inside the block: the fp32 fused conv as it ran before the
    3×TF32 kernel, measured beside it on the same inputs (that path's code
    is unchanged since)."""
    routed = tc.route
    tc.route = lambda dtype, *shape: ("mma_sync" if dtype == torch.float32 else
                                      routed(dtype, *shape))
    try:
        yield
    finally:
        tc.route = routed


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int = 25) -> float:
    """Median of ``reps`` single launches timed with CUDA events, the L2
    cache flushed before each (the synthesis path finds its inputs cold).
    The card spins for about a millisecond before each start event, so the
    wrapper's host work is enqueued behind it and the events time the
    kernels alone, not the host's launch overhead."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k3_tol_ratio(torch, ours, ref, x, a, b) -> float:
    """max |ours − ref| over K3's elementwise tolerance: one bf16 ulp of
    ``ref`` (a rounding flip of the final cast) plus 2^-20·(|x·a| + |b|)
    (a few fp32 ulps of the argument u = x·a + b, should the two sides
    round u differently; silu' ≤ 1.1). ≤ 1 passes."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0**-126))) - 7)
    bc = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    scale = (x.float() * a.reshape(bc)).abs() + b.reshape(bc).abs()
    return float(((ours.float() - ref).abs() / (ulp + 2.0**-20 * scale)).max())


def phase_kernels(torch, F) -> dict:
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet as wv
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    torch.backends.cudnn.allow_tf32 = False  # fp32 library yardsticks in fp32
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    # Haar filters of the 8 bands as one stride-2 convolution (the library
    # call computing the same function as K1; its transpose computes K2)
    w = torch.as_tensor(wv._haar_mixing_matrix(), dtype=torch.float32, device="cuda")
    w = w.reshape(8, 1, 2, 2, 2)

    x = torch.rand((1, *VOLUME), generator=g, device="cuda")
    y = wc.haar_dwt3(x)
    err = float((y - wc.haar_dwt3_plain(x)).abs().max())
    lib = F.conv3d(x[:, None], w, stride=2).permute(0, 2, 3, 4, 1)
    nb = 2 * x.numel() * 4
    b_ms, b_by = bound_ms(nb, 6 * x.numel())
    out["haar_dwt3"] = dict(
        shape=list(x.shape), max_abs_err=err, tol=1e-5,
        library_max_abs_err=float((lib - y).abs().max()),
        ms=time_ms(torch, lambda: wc.haar_dwt3(x)),
        plain_ms=time_ms(torch, lambda: wc.haar_dwt3_plain(x)),
        library_ms=time_ms(torch, lambda: F.conv3d(x[:, None], w, stride=2)),
        bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )

    yb = torch.randn((1, *LATENT, 8), generator=g, device="cuda")
    xi = wc.haar_idwt3(yb)
    err = float((xi - wc.haar_idwt3_plain(yb)).abs().max())
    yb_ncdhw = yb.permute(0, 4, 1, 2, 3)
    lib = F.conv_transpose3d(yb_ncdhw, w, stride=2)[:, 0]
    b_ms, b_by = bound_ms(nb, 6 * xi.numel())
    out["haar_idwt3"] = dict(
        shape=list(yb.shape), max_abs_err=err, tol=1e-5,
        library_max_abs_err=float((lib - xi).abs().max()),
        ms=time_ms(torch, lambda: wc.haar_idwt3(yb)),
        plain_ms=time_ms(torch, lambda: wc.haar_idwt3_plain(yb)),
        library_ms=time_ms(torch, lambda: F.conv_transpose3d(yb_ncdhw, w, stride=2)),
        bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )
    torch.backends.cudnn.allow_tf32 = True

    # K3: bf16 at each level width, B = 1 and 2, both memory formats, held
    # to the elementwise tolerance of k3_tol_ratio. Kernel and plain version
    # run the same fp32 operations in the same order, so the expected
    # disagreement is none; the count of differing elements is printed.
    checks, worst_err, worst_ratio = [], 0.0, 0.0
    for c, sp in K3_SHAPES:
        for bsz in (1, 2):
            xs = torch.randn((bsz, *sp, c), generator=g, device="cuda").to(torch.bfloat16)
            a = torch.randn((bsz, c), generator=g, device="cuda")
            b = torch.randn((bsz, c), generator=g, device="cuda")
            for fmt, t in (("channels_last_3d", xs.permute(0, 4, 1, 2, 3)),
                           ("contiguous", xs.permute(0, 4, 1, 2, 3).contiguous())):
                ours, ref = ec.affine_silu(t, a, b), ec.affine_silu_plain(t, a, b)
                if ours.stride() != t.stride():
                    fail(f"K3 changed the memory format ({fmt})")
                ratio = k3_tol_ratio(torch, ours, ref, t, a, b)
                err = float((ours.float() - ref.float()).abs().max())
                checks.append(dict(c=c, spatial=list(sp), batch=bsz, format=fmt,
                                   max_abs_err=err, tol_ratio=ratio,
                                   n_differ=int((ours != ref).sum())))
                worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
    c, sp = K3_SHAPES[0]
    xs = torch.randn((1, *sp, c), generator=g, device="cuda").to(torch.bfloat16)
    t = xs.permute(0, 4, 1, 2, 3)
    a = torch.randn((1, c), generator=g, device="cuda")
    b = torch.randn((1, c), generator=g, device="cuda")
    nb = 2 * t.numel() * 2 + 2 * a.numel() * 4
    b_ms, b_by = bound_ms(nb, 6 * t.numel())
    out["affine_silu"] = dict(
        shape=list(t.shape), dtype="bfloat16", max_abs_err=worst_err,
        tol_ratio=worst_ratio, tol="1 bf16 ulp of y + 2^-20 (|x a| + |b|)", checks=checks,
        ms=time_ms(torch, lambda: ec.affine_silu(t, a, b)),
        plain_ms=time_ms(torch, lambda: ec.affine_silu_plain(t, a, b)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )
    for name in ("haar_dwt3", "haar_idwt3"):
        if not out[name]["max_abs_err"] <= 1e-5:
            fail(f"{name} disagrees with its plain version: {out[name]['max_abs_err']}")
    if not worst_ratio <= 1.0:
        fail(f"affine_silu disagrees with its plain version: {checks}")
    out["gn_stats"] = gn_stats_leg(torch, ec, g)
    return out


def gn_stats_leg(torch, ec, g) -> dict:
    """GroupNorm's statistics kernel at the forward's largest site (level
    0, 192 channels, bf16 channels_last_3d, 192.7 M elements), both
    formulas against the plain version (the torch statistics synthesis ran
    before the kernel) on the same tensor: mean within 1e-5 of the group's
    |mean| + std, inv within 1e-5 relative; one launch a call, two calls
    bit for bit; the kernel's time and the plain version's against one
    read of x."""
    c = 192
    xs = torch.randn((1, *LATENT, c), generator=g, device="cuda")
    x = (xs * 1.5 + 0.25).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    del xs
    errors = {}
    for name, formula in (("group", ec.GN_GROUP), ("channel_means", ec.GN_CHANNEL_MEANS)):
        before = ec.gn_stats.launches
        (mean, inv), again = ec.gn_stats(x, 32, formula), ec.gn_stats(x, 32, formula)
        rmean, rinv = ec.gn_stats_plain(x, 32, formula)
        errors[name] = {
            "mean": float(((mean - rmean).abs() / (rmean.abs() + 1.0 / rinv)).max()),
            "inv": float(((inv - rinv).abs() / rinv).max()),
            "launches_per_call": (ec.gn_stats.launches - before) / 2,
            "repeat_bit_for_bit": bool(torch.equal(mean, again[0]) and torch.equal(inv, again[1]))}
    worst = max(max(e["mean"], e["inv"]) for e in errors.values())
    nb = x.numel() * x.element_size() + 2 * c * 4
    b_ms, b_by = bound_ms(nb, 2 * x.numel())
    res = dict(
        shape=list(x.shape), dtype="bfloat16", max_abs_err=worst, tol=1e-5,
        tol_ratio=worst / 1e-5, errors=errors,
        ms=time_ms(torch, lambda: ec.gn_stats(x, 32, ec.GN_GROUP)),
        plain_ms=time_ms(torch, lambda: ec.gn_stats_plain(x, 32, ec.GN_GROUP)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nb,
    )
    if not worst <= 1e-5 or not all(e["repeat_bit_for_bit"] and e["launches_per_call"] == 1
                                    for e in errors.values()):
        fail(f"gn_stats disagrees with its plain version: {res}")
    return res


def conv_inputs(torch, g, bsz, ci, sp, co, dtype):
    """x (channels_last_3d), w (3,3,3,Ci,Co), b, and GN statistics of x
    with a nonzero bias (pro(0) != 0 tests the zero padding)."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    x = torch.randn((bsz, *sp, ci), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
    w = torch.randn((3, 3, 3, ci, co), generator=g, device="cuda") * (27 * ci) ** -0.5
    b = 0.02 * torch.randn(co, generator=g, device="cuda")
    mean, inv = tc.group_stats(x, math.gcd(ci, 32))
    scale = 1.0 + 0.05 * torch.randn(ci, generator=g, device="cuda")
    bias = 0.3 + 0.05 * torch.randn(ci, generator=g, device="cuda")
    return x, w, b, (mean, inv, scale, bias)


def conv_cost(x, co, extra_out: int = 0) -> tuple[int, int]:
    """(bytes, flops) of one fused conv: x, w and the output (and skip)
    once each; 2·voxels·Co·27·Ci operations."""
    ci = x.shape[1]
    vox = x.numel() // ci
    esize = x.element_size()
    n_bytes = (x.numel() + 27 * ci * co + (1 + extra_out) * vox * co) * esize
    return n_bytes, 2 * vox * co * 27 * ci


def phase_conv(torch, F) -> dict:
    """The fused conv behind K4a, K4b and K5, the hand-written kernels
    against the plain version: the wgmma kernel (``conv3d_wgmma.cu``, bf16
    with Ci % 16 == 0 and Co % 64 == 0, or Co % 32 == 0 at 32-wide blocks,
    ``wgmma_n32``) and the split-K kernel (``conv3d_splitk.cu``, bf16, Co %
    64 == 0, where its halo fits), and the mma.sync kernel
    (``conv3d.cu``), at every shape of CONV_SHAPES each takes (K4b with the
    GN prologue and without, K4a with fold_taps both ways, K5 with temb and
    skip; the routed kernel through each entry point, and twice, bit for
    bit) and the level-1 shape in fp32 (mma.sync only). Then, at every
    distinct conv shape of the production forward and at the tp axis's six
    Co/2 shapes of TP_N32_CONVS, the time of each kernel with the prologue
    (the routed one without it too), of cuDNN (``F.conv3d`` bf16
    channels_last_3d, the conv alone) and the bound, beside the kernel
    ``route`` picks and the split-K plan; the fp32 level-1 and the B = 2
    shapes on their routed kernel beside cuDNN in their dtype (TF32 off);
    and at level 0 each entry point through the routed kernel."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    g = torch.Generator(device="cuda").manual_seed(2)
    checks, worst = [], {"k4a": [0.0, 0.0], "k4b": [0.0, 0.0], "k5": [0.0, 0.0]}

    def check(entry, label, kernel, y, ref, x, w, gn, **info):
        ratio = tc.tol_ratio(y, ref, x, w, gn)
        err = float((y.float() - ref.float()).abs().max())
        checks.append(dict(entry=entry, kernel=kernel, shape=label, x=list(x.shape),
                           co=w.shape[-1], dtype=str(x.dtype).split(".")[-1], max_abs_err=err,
                           tol_ratio=ratio, n_differ=int((y != ref).sum()), **info))
        worst[entry] = [max(worst[entry][0], err), max(worst[entry][1], ratio)]

    def twice(fn):
        y, again = fn(), fn()
        return y, bool(torch.equal(y, again))

    shapes = [(lab, b, ci, sp, co, torch.bfloat16) for lab, b, ci, sp, co in CONV_SHAPES]
    shapes += [(lab, b, ci, sp, co, torch.float32) for lab, b, ci, sp, co in FP32_CONV_SHAPES]
    for label, bsz, ci, sp, co, dtype in shapes:
        x, w, b, gn = conv_inputs(torch, g, bsz, ci, sp, co, dtype)
        temb = torch.randn((bsz, co), generator=g, device="cuda")
        skip = torch.randn((bsz, *sp, co), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
        ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
        ref_np = tc.conv3d_fused_plain(x, w, b)
        ref_v4 = tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip)
        # the entry points, on the kernel route() picks, each twice
        routed = tc.route(dtype, bsz, ci, co, *sp)
        if dtype == torch.float32 and bsz == 1 and routed != "wgmma_tf32":
            fail(f"the fp32 production conv {label} is routed to {routed}")
        wp = packed_for(tc, routed, w)
        y, same = twice(lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=wp))
        check("k4b", label, routed, y, ref, x, w, gn, prologue=True, bit_identical_twice=same)
        del y
        for fold in (True, False):
            y, same = twice(lambda: tc.conv3d_fused(x, w, b, gn=gn, fold_taps=fold, w_packed=wp))
            check("k4a", label, routed, y, ref, x, w, gn, prologue=True, fold_taps=fold,
                  bit_identical_twice=same)
        y, same = twice(lambda: tc.conv3d_fused(x, w, b, block_x=2, w_packed=wp))
        check("k4b", label, routed, y, ref_np, x, w, None, prologue=False, bit_identical_twice=same)
        y, same = twice(lambda: tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip,
                                                   w_packed=wp))
        check("k5", label, routed, y, ref_v4, x, w, gn, prologue=True, temb=True, skip=True,
              bit_identical_twice=same)
        del y
        # the other kernels, where they take the shape
        for other in takers(tc, torch, bsz, ci, co, sp, dtype):
            if other == routed:
                continue
            for entry, (g_, t_, s_, r_) in {"k4b": (gn, None, None, ref),
                                            "k4b_np": (None, None, None, ref_np),
                                            "k5": (gn, temb, skip, ref_v4)}.items():
                check(entry[:3], label, other,
                      tc._launch(entry, x, w, b, g_, t_, s_, packed_for(tc, other, w), other),
                      r_, x, w, g_, prologue=g_ is not None, temb=t_ is not None,
                      skip=s_ is not None)
        del x, w, gn, temb, skip, ref, ref_np, ref_v4
    torch.cuda.empty_cache()

    # every distinct production conv shape and the six tp Co/2 shapes:
    # each kernel that takes the shape with the prologue (the routed one
    # without it too), cuDNN's conv alone, the bound, the route and the
    # split-K plan
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    timings = conv_timings(torch, F, tc, g, PRODUCTION_CONVS, n_sm)
    tp_timings = conv_timings(torch, F, tc, g, TP_N32_CONVS, n_sm)
    # the same 16 shapes in fp32: the 3×TF32 kernel and conv3d.cu's fp32
    # path, each with and without the prologue, cuDNN fp32 (TF32 off), the
    # plain version, the 3×TF32 and the FFMA bounds
    fp32_timings = conv_timings(torch, F, tc, g, PRODUCTION_CONVS, n_sm, torch.float32)
    # the B = 2 conv of CONV_SHAPES, with the prologue, on the kernel
    # route() picks
    label, bsz, ci, sp, co, dtype = next(shape for shape in shapes if shape[1] == 2)
    x, w, b, gn = conv_inputs(torch, g, bsz, ci, sp, co, dtype)
    nb, fl = conv_cost(x, co)
    b_ms, b_by = bound_ms(nb, fl, PEAK_BF16_FLOPS)
    w_lib = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    b_lib = b.to(dtype)
    other_timings = [dict(
        shape=label, x=list(x.shape), co=co, dtype=str(dtype).split(".")[-1],
        route=tc.route(dtype, bsz, ci, co, *sp),
        ms=time_ms(torch, lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2), reps=10),
        cudnn_ms=time_ms(torch, lambda: F.conv3d(x, w_lib, b_lib, padding=1), reps=10),
        cudnn="F.conv3d in x's dtype, channels_last_3d, the conv alone",
        bound_ms=b_ms, bound_by=b_by)]
    del x, w, gn, w_lib
    torch.cuda.empty_cache()

    # level 0, 64 → 64: each entry point through the routed kernel, its
    # plain version, cuDNN; the wgmma kernel without the prologue (cuDNN's
    # function); the mma.sync kernel
    x, w, b, gn = conv_inputs(torch, g, *CONV_SHAPES[0][1:], torch.bfloat16)
    co = w.shape[-1]
    wp = tc.pack_wgmma_weights(w)
    temb = torch.randn((1, co), generator=g, device="cuda")
    skip = torch.randn((1, *CONV_SHAPES[0][3], co), generator=g, device="cuda")
    skip = skip.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    w_lib = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    b_lib = b.to(torch.bfloat16)
    lib_ms = time_ms(torch, lambda: F.conv3d(x, w_lib, b_lib, padding=1))
    runs = {  # the entry point; the mma.sync kernel on the same call; the plain version
        "k4b": (lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=wp),
                lambda: tc._launch("k4b", x, w, b, gn, None, None, kernel="mma_sync"),
                lambda: tc.conv3d_fused_plain(x, w, b, gn=gn), 0),
        "k4a": (lambda: tc.conv3d_fused(x, w, b, gn=gn, w_packed=wp),
                lambda: tc._launch("k4a", x, w, b, gn, None, None, kernel="mma_sync"),
                lambda: tc.conv3d_fused_plain(x, w, b, gn=gn), 0),
        "k5": (lambda: tc.conv3d_fused_v4(x, w, b, gn=gn, temb=temb, skip=skip, w_packed=wp),
               lambda: tc._launch("k5", x, w, b, gn, temb, skip, kernel="mma_sync"),
               lambda: tc.conv3d_fused_v4_plain(x, w, b, gn=gn, temb=temb, skip=skip), 1),
    }
    routed = tc.route(x.dtype, *x.shape[:2], co, *x.shape[2:])
    out = {}
    for entry, (kern, mma_sync, plain, extra) in runs.items():
        nb, fl = conv_cost(x, co, extra)
        b_ms, b_by = bound_ms(nb, fl, PEAK_BF16_FLOPS)
        out[entry] = dict(
            shape=list(x.shape), co=co, dtype="bfloat16", kernel=routed,
            max_abs_err=worst[entry][0], tol_ratio=worst[entry][1], tol=CONV_TOL,
            ms=time_ms(torch, kern), mma_sync_ms=time_ms(torch, mma_sync),
            plain_ms=time_ms(torch, plain, reps=5), library_ms=lib_ms,
            library="F.conv3d bf16 channels_last_3d (cuDNN), the conv alone, no prologue"
                    + (" or temb/skip" if extra else ""),
            bound_ms=b_ms, bound_by=b_by, bytes=nb, flops=fl,
        )
    out["level0_wgmma_no_prologue_ms"] = time_ms(
        torch, lambda: tc._launch("no prologue", x, w, b, None, None, None, wp, "wgmma"))
    out["level0_mma_sync_no_prologue_ms"] = time_ms(
        torch, lambda: tc._launch("no prologue", x, w, b, None, None, None, kernel="mma_sync"))
    out["checks"], out["timings"], out["other_timings"] = checks, timings, other_timings
    out["tp_timings"], out["fp32_timings"] = tp_timings, fp32_timings
    # launch-weighted ms per forward of each kernel over the shapes route()
    # gives it, beside cuDNN's and the bound's over the same shapes
    out["by_route"] = by_route(timings)
    # a tp rank's six Co/2 shapes (20 launches a forward): on their route,
    # on mma.sync (their route before the 32-wide kernel), cuDNN, the bound
    out["tp_co2_per_forward"] = {
        f"{key}_per_forward": sum(r[key] * r["per_forward"] for r in tp_timings)
        for key in ("routed_ms", "mma_sync_ms", "cudnn_ms", "bound_ms")} | {
        "launches_per_forward": sum(r["per_forward"] for r in tp_timings),
        "routes": sorted({r["route"] for r in tp_timings})}
    deep = next(r for r in timings if r["x"][2:] == [7, 7, 5] and r["x"][1] == 256)
    out["deep_levels"] = dict(out["by_route"]["splitk"], shape_7x7x5_256to256={
        key: deep[key] for key in ("splitk_ms", "routed_no_prologue_ms", "wgmma_ms", "mma_sync_ms",
                                   "cudnn_ms", "bound_ms", "bound_by", "splitk_plan")})
    # an fp32 forward's 54 convs, launch-weighted: on their route, on each
    # fp32 kernel, cuDNN fp32, the plain version, both bounds; by route and
    # over levels 0-2 (30 launches)
    keys = ("routed_ms", "wgmma_tf32_ms", "mma_sync_ms", "cudnn_ms", "plain_ms", "bound_ms",
            "bound_ffma_ms")
    out["fp32_per_forward"] = {
        f"{key}_per_forward": sum(r[key] * r["per_forward"] for r in fp32_timings) for key in keys
    } | {"levels_0_2": {key: sum(r[key] * r["per_forward"] for r in fp32_timings
                                 if r["x"][2] >= 28) for key in keys},
         "by_route": {k: v for k, v in by_route(fp32_timings).items()
                      if v["launches_per_forward"]}}
    # the kernels line's fp32 record: level 1, 128 → 128, on the 3×TF32
    # kernel, beside conv3d.cu's fp32 path, cuDNN fp32 and the plain version
    lvl1 = next(r for r in fp32_timings if r["x"] == [1, 128, 56, 56, 40] and r["co"] == 128)
    tf = [c for c in checks if c["kernel"] == "wgmma_tf32"]
    out["fp32"] = dict(
        shape=lvl1["x"], co=128, dtype="float32", kernel="wgmma_tf32",
        max_abs_err=max(c["max_abs_err"] for c in tf), tol_ratio=max(c["tol_ratio"] for c in tf),
        tol=CONV_TOL, ms=lvl1["wgmma_tf32_ms"], no_prologue_ms=lvl1["wgmma_tf32_no_prologue_ms"],
        mma_sync_ms=lvl1["mma_sync_ms"], plain_ms=lvl1["plain_ms"], library_ms=lvl1["cudnn_ms"],
        library="F.conv3d fp32 channels_last_3d (cuDNN), TF32 off, the conv alone",
        bound_ms=lvl1["bound_ms"], bound_by=lvl1["bound_by"], bound_ffma_ms=lvl1["bound_ffma_ms"],
        bound="3 TF32 products a term at 495 TFLOP/s (bound_ffma_ms: 1 at 67 TFLOP/s)")
    # how the kernel's split and its tensor cores read fp32
    out["tf32_rna_mismatches"] = tc.tf32_rna_mismatches()
    out["tf32_read"] = tc.tf32_read_mode()
    if out["tf32_rna_mismatches"][0] or out["tf32_read"]["mode"] not in ("truncate", "round"):
        fail(f"the 3×TF32 kernel's split or operand reading is not as modelled: "
             f"{out['tf32_rna_mismatches']} {out['tf32_read']}")
    # every kernel within tol_ratio 1; the 3×TF32 kernel within its own
    # TF32_TOL_RATIO, below which a truncating sum over all of K stays
    bad = [c for c in checks
           if not c["tol_ratio"] <= (tc.TF32_TOL_RATIO if c["kernel"] == "wgmma_tf32" else 1.0)
           or not c.get("bit_identical_twice", True)]
    if bad:
        fail(f"the fused conv disagrees with its plain version or itself: {bad}")
    if any(r["route"] != "wgmma_tf32" for r in fp32_timings):
        fail(f"an fp32 production conv is routed to mma.sync: {fp32_timings}")
    if any(r["route"] == "mma_sync" for r in tp_timings):
        fail(f"a tp Co/2 shape is routed to mma.sync: {tp_timings}")
    # the wgmma kernel's prologue divides by its own branch-free reciprocal
    out["wgmma_recip_mismatches_of_2_126_range"] = tc.recip_mismatches()
    if out["wgmma_recip_mismatches_of_2_126_range"]:
        fail("the wgmma kernel's reciprocal differs from IEEE 1/d on [1, 2^126)")
    return out


def takers(tc, torch, bsz, ci, co, sp, dtype=None) -> list:
    """The conv kernels that take this shape in ``dtype`` (bf16 when None)."""
    out = ["mma_sync"]
    if dtype == torch.float32:
        return out + (["wgmma_tf32"] if ci % tc.TF_BK == 0 and co % tc.TF_BN == 0 else [])
    if ci % tc.WG_BK == 0 and co % tc.WG_BN32 == 0:
        out.append("wgmma_n32")
    if ci % tc.WG_BK == 0 and co % tc.WG_BN == 0:
        out.append("wgmma")
        if tc.splitk_plan(bsz, ci, co, *sp, 1)["fits"]:
            out.append("splitk")
    return out


def packed_for(tc, kernel: str, w):
    """``w`` packed as ``kernel`` reads it, or None where the kernel reads
    the DHWIO weight (mma.sync)."""
    return tc.pack_weights(w, *tc.PACK[kernel]) if kernel in tc.PACK else None


def conv_timings(torch, F, tc, g, convs: dict, n_sm: int, dtype=None) -> list:
    """For each ((X, Y, Z), Ci, Co): per_forward of ``convs``, B = 1, in
    ``dtype`` (bf16 when None): the ms of each kernel that takes it with the
    prologue (None where none), of the routed one without the prologue, of
    cuDNN's conv alone (TF32 off), and the bound; the route and, in bf16,
    the split-K plan. In fp32 also each kernel without the prologue, the
    plain version (3 reps), and two bounds: ``bound_ms`` at three TF32
    products a term (the 3×TF32 kernel's work) and ``bound_ffma_ms`` at
    the fp32 FFMA rate."""
    fp32 = dtype == torch.float32
    dtype = dtype or torch.bfloat16
    rows = []
    for (sp, ci, co), per_forward in convs.items():
        x, w, b, gn = conv_inputs(torch, g, 1, ci, sp, co, dtype)
        w_lib = w.to(dtype).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        b_lib = b.to(dtype)
        nb, fl = conv_cost(x, co)
        b_ms, b_by = (bound_ms(nb, 3 * fl, PEAK_TF32_FLOPS) if fp32 else
                      bound_ms(nb, fl, PEAK_BF16_FLOPS))
        plan = tc.splitk_plan(1, ci, co, *sp, n_sm) if co % tc.WG_BN == 0 and not fp32 else None
        take = takers(tc, torch, 1, ci, co, sp, dtype)
        routed = tc.route(x.dtype, 1, ci, co, *sp)
        ms = {}
        for k in CONV_KERNELS:
            wp = packed_for(tc, k, w) if k in take else None
            ms[k] = (time_ms(torch, lambda: tc._launch("k4b", x, w, b, gn, None, None, wp, k),
                             reps=10) if k in take else None)
            if k == routed or (fp32 and k in take):  # the prologue's share
                ms[f"{k}_no_prologue"] = time_ms(
                    torch, lambda: tc._launch("k4b", x, w, b, None, None, None, wp, k), reps=10)
            del wp
        with no_tf32(torch):
            cudnn_ms = time_ms(torch, lambda: F.conv3d(x, w_lib, b_lib, padding=1), reps=10)
        rows.append(dict(
            x=list(x.shape), co=co, per_forward=per_forward, route=routed,
            **{f"{k}_ms": ms[k] for k in CONV_KERNELS}, routed_ms=ms[routed],
            routed_no_prologue_ms=ms[f"{routed}_no_prologue"], cudnn_ms=cudnn_ms,
            bound_ms=b_ms, bound_by=b_by, gflop=fl / 1e9, mbytes=nb / 1e6,
            splitk_plan=plan and dict(bm=plan["bm"], S=plan["S"], grid=plan["grid"],
                                      ctas=plan["ctas"],
                                      workspace_mb=plan["workspace_bytes"] / 1e6,
                                      smem_bytes=plan["smem_bytes"], fits=plan["fits"])))
        if fp32:
            rows[-1].update(
                {f"{k}_no_prologue_ms": ms[f"{k}_no_prologue"] for k in take},
                plain_ms=time_ms(torch, lambda: tc.conv3d_fused_plain(x, w, b, gn=gn), reps=3),
                bound_ffma_ms=bound_ms(nb, fl)[0])
        del x, w, gn, w_lib
    torch.cuda.empty_cache()
    return rows


def by_route(timings: list) -> dict:
    """Launch-weighted ms per forward of each kernel over the shapes
    ``route`` gives it, beside cuDNN's and the bound's over the same
    shapes."""
    return {k: {f"{key}_per_forward": sum(r[key] * r["per_forward"] for r in timings
                                          if r["route"] == k)
                for key in (f"{k}_ms", "cudnn_ms", "bound_ms")}
            | {"launches_per_forward": sum(r["per_forward"] for r in timings if r["route"] == k)}
            for k in CONV_KERNELS}


@functools.lru_cache(maxsize=1)
def seeded_arrays(shapes: tuple) -> dict:
    """``seeded_state_dict`` of ``(name, shape)`` pairs, made once per
    process (~4 s of host time for the production UNet)."""
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    return seeded_state_dict(dict(shapes))


def seeded_production(torch, **overrides) -> tuple[dict, dict]:
    """The production config and its seeded weights (a torch state_dict of
    fresh tensors), checked to be the 81,511,048-parameter model."""
    from fast_cwdm_tpu_torch.cli import common

    cfg = common.production_config(sample_schedule="sampled", diffusion_steps=10, **overrides)
    model, _ = common.build_model_and_diffusion(cfg)
    shapes = tuple((k, tuple(v.shape)) for k, v in model.state_dict().items())
    sd = {k: torch.from_numpy(v.copy()) for k, v in seeded_arrays(shapes).items()}
    n = sum(v.numel() for v in sd.values())
    if n != 81_511_048:
        fail(f"production UNet has {n} parameters, expected 81,511,048")
    return cfg, sd


def profile_device(torch, fn) -> dict:
    """Device time of one call of ``fn`` by kernel (``utils.devtime``, after
    one warm call): the total, the busy share of the host-clock wall time,
    sums by kind, and the top kernels."""
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    res = devtime(fn, iters=1, detail=True)
    kinds = (("K3 VJP affine_silu_bwd", ("affine_silu_bwd",)),
             ("K3 affine_silu", ("affine_silu",)),
             ("K4b fused conv3d, 3xTF32 wgmma (fp32)", ("conv3d_tf32",)),
             ("K4b fused conv3d, wgmma", ("conv3d_wgmma",)),
             ("K4b fused conv3d, split-K", ("conv3d_splitk_kernel",)),
             ("K4b fused conv3d, split-K reduction", ("conv3d_splitk_reduce",)),
             ("K4b fused conv3d, mma.sync", ("conv3d_bf16", "conv3d_f32")),
             ("convolution backward (cuDNN dgrad, wgrad)", ("dgrad", "wgrad")),
             ("convolution", ("conv", "xmma", "cudnn", "fprop", "implicit", "gemm")),
             ("optimizer and EMA (foreach)", ("foreach", "multi_tensor")),
             ("reduction (GroupNorm statistics)", ("reduce",)),
             ("elementwise and copies", ("elementwise", "copy", "cat", "upsample",
                                         "avg_pool", "index")))
    sums = {}
    for name, ms in res["ops"].items():
        kind = next((k for k, keys in kinds if any(w in name.lower() for w in keys)), "other")
        sums[kind] = sums.get(kind, 0.0) + ms
    return {"wall_ms": res["wall_ms"], "device_ms": res["total_ms"],
            "busy_share": res["busy_share"], "source": res.get("source"),
            "records_missing": res.get("records_missing"),
            "by_kind_ms": dict(sorted(sums.items(), key=lambda kv: -kv[1])),
            "top_kernels": [dict(ms=ms, name=k[:90]) for k, ms in list(res["ops"].items())[:12]]}


FORWARD_VARIANTS = {"unfused": {}, "fused": dict(fuse_gn_silu=True),
                    "fuse_conv": dict(fuse_conv=True)}


def phase_forward(torch, profile: bool = False) -> dict:
    """The production forward unfused, with fuse_gn_silu (K3) and with
    fuse_conv (K4b), timed in turns (u, f, c, c, f, u; two rounds; host
    clock around a synchronised forward), and the fp32 forward as the
    yardstick of bf16's own error. Then the fp32 forward with fuse_conv
    (its 54 convs on the 3×TF32 kernel) against the unfused fp32 forward
    (TF32 off), within 1e-4 of the output's scale: its launches by kernel,
    each forward's device ms (CUDA events) and the fused one's device ms by
    kind (``devtime``'s profiler)."""
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    cfg, sd = seeded_production(torch)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, *LATENT, 32), generator=g, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([9], device="cuda")
    models = {}
    for name, flags in FORWARD_VARIANTS.items():
        m, _ = common.build_model_and_diffusion(dict(cfg, **flags))
        m.load_state_dict(sd)
        models[name] = m.cuda().eval()
    times = {name: [] for name in models}
    with torch.inference_mode():
        outs = {name: m(x, t) for name, m in models.items()}
        for _ in range(2):
            for name in ("unfused", "fused", "fuse_conv", "fuse_conv", "fused", "unfused"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models[name](x, t)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    res = {}
    for name in models:
        res[f"{name}_ms"] = statistics.median(times[name])
        res[f"{name}_ms_all"] = times[name]
    if profile:
        with torch.inference_mode():
            res["profile"] = {name: profile_device(torch, lambda: m(x, t))
                              for name, m in models.items()}
    del models
    m32 = {}
    for name, flags in (("fp32", {}), ("fp32_fuse_conv", dict(fuse_conv=True))):
        m, _ = common.build_model_and_diffusion(dict(cfg, dtype="float32", **flags))
        m.load_state_dict(sd)
        m32[name] = m.cuda().eval()
    with no_tf32(torch), torch.inference_mode():
        before = ops.launch_counts()
        y32, y32c = (m(x, t) for m in m32.values())
        launched = ops.launches_since(before)
        dev_ms = {name: devtime(lambda: m(x, t), iters=2, events=True)["total_ms"]
                  for name, m in m32.items()}
        prof = profile_device(torch, lambda: m32["fp32_fuse_conv"](x, t))
        with fp32_on_conv3d_cu(torch, tc):  # the same forward on conv3d.cu's FFMA path
            before = ops.launch_counts()
            y32f = m32["fp32_fuse_conv"](x, t)
            launched_ffma = ops.launches_since(before)
            dev_ms["ffma"] = devtime(lambda: m32["fp32_fuse_conv"](x, t), iters=2,
                                     events=True)["total_ms"]
            prof_ffma = profile_device(torch, lambda: m32["fp32_fuse_conv"](x, t))
    del m32
    want = {f"conv3d_{k}": sum(n for (sp, ci, co), n in PRODUCTION_CONVS.items()
                               if tc.route(torch.float32, 1, ci, co, *sp) == k)
            for k in CONV_KERNELS}
    res["fp32_fuse_conv"] = {
        "max_abs_diff_vs_fp32": float((y32c - y32).abs().max()),
        "tol": 1e-4 * float(y32.abs().max()), "launches": launched,
        "launches_expected_by_kernel": want, "device_ms": dev_ms["fp32_fuse_conv"],
        "fp32_unfused_device_ms": dev_ms["fp32"], "profile": prof,
        # conv3d.cu's FFMA path for every fused conv (fp32_on_conv3d_cu)
        "ffma": {"max_abs_diff_vs_fp32": float((y32f - y32).abs().max()),
                 "launches": launched_ffma, "device_ms": dev_ms["ffma"], "profile": prof_ffma}}
    if not (max(res["fp32_fuse_conv"]["max_abs_diff_vs_fp32"],
                res["fp32_fuse_conv"]["ffma"]["max_abs_diff_vs_fp32"])
            <= res["fp32_fuse_conv"]["tol"]
            and bool(torch.isfinite(y32c).all()) and launched.get("conv3d_fused_k4b") == 54
            and all(launched.get(k, 0) == n for k, n in want.items())
            and launched_ffma.get("conv3d_mma_sync") == 54):
        fail(f"the fp32 fuse_conv forward disagrees with the fp32 one or its routes: "
             f"{res['fp32_fuse_conv']}")
    y0 = outs["unfused"]
    for y in outs.values():
        if tuple(y.shape) != (1, 8, *LATENT) or not bool(torch.isfinite(y).all()):
            fail("production forward gave a wrong shape or non-finite values")
    res["max_abs_diff_fused_vs_unfused"] = float((outs["fused"] - y0).abs().max())
    res["max_abs_diff_fuse_conv_vs_unfused"] = float((outs["fuse_conv"] - y0).abs().max())
    res["max_abs_diff_bf16_vs_fp32"] = float((y0 - y32).abs().max())
    res["max_abs_output"] = float(y32.abs().max())
    # the variants round in different places; they may disagree by up to
    # twice what bf16 itself costs against fp32 (the CPU test's bound)
    res["tol"] = 2.0 * res["max_abs_diff_bf16_vs_fp32"]
    if not max(res["max_abs_diff_fused_vs_unfused"],
               res["max_abs_diff_fuse_conv_vs_unfused"]) <= res["tol"]:
        fail(f"a fused forward disagrees with the unfused one: {res}")
    return res


def write_case(case_dir: str, seed: int = 0) -> None:
    """Four 240×240×155 modalities inside an ellipsoidal 'brain', zero
    outside, in BraTS file naming: :func:`case_files` of ``seed`` copied
    under the case's names (copies, not links: a writer of one case's file
    must not reach the other cases)."""
    import shutil

    os.makedirs(case_dir, exist_ok=True)
    base = os.path.basename(case_dir)
    for m in ("t1n", "t1c", "t2w", "t2f"):
        shutil.copyfile(os.path.join(case_files(seed), f"{m}.nii.gz"),
                        os.path.join(case_dir, f"BraTS-GLI-{base}-000-{m}.nii.gz"))


@functools.lru_cache(maxsize=None)
def cases_root() -> tempfile.TemporaryDirectory:
    return tempfile.TemporaryDirectory(prefix="chip_smoke_cases_")


@functools.lru_cache(maxsize=None)
def case_files(seed: int) -> str:
    """The directory of ``seed``'s four volumes, made once per run (~7 s of
    host time a case)."""
    case_dir = os.path.join(cases_root().name, str(seed))
    make_case(case_dir, seed)
    return case_dir


def make_case(case_dir: str, seed: int) -> None:
    """:func:`write_case`'s four volumes of ``seed``, as ``<modality>.nii.gz``."""
    import numpy as np

    from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, save

    os.makedirs(case_dir)
    rng = np.random.default_rng(seed)
    gx, gy, gz = np.meshgrid(
        *(np.linspace(-1, 1, n, dtype=np.float32) for n in (240, 240, 155)), indexing="ij"
    )
    brain = (gx / 0.7) ** 2 + (gy / 0.8) ** 2 + (gz / 0.85) ** 2 < 1.0
    for k, m in enumerate(("t1n", "t1c", "t2w", "t2f")):
        tissue = 300 + 200 * np.sin(3 * gx + k) * np.cos(2 * gy - k) + 50 * gz
        vol = np.where(brain, tissue + 20 * rng.standard_normal(brain.shape), 0.0)
        save(Nifti1Image(np.maximum(vol, 0).astype(np.float32), np.eye(4)),
             os.path.join(case_dir, f"{m}.nii.gz"))


def reset_counts():
    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.diffusion import graph

    ops.set_launch_counts(dict.fromkeys(ops.launch_counts(), 0))
    graph.counts.update(captures=0, replays=0)


def read_counts() -> dict:
    from fast_cwdm_tpu_torch import ops

    return ops.launch_counts()


def check_sample(np, path: str, mask) -> list:
    """The written sample: (224, 224, 155), finite, in [0,1], zero outside
    the brain mask."""
    from fast_cwdm_tpu_torch.data.nifti import load

    got = load(path).get_fdata()
    if got.shape != (224, 224, 155) or not np.isfinite(got).all():
        fail(f"{path} has shape {got.shape} or non-finite values")
    if got.min() < 0.0 or got.max() > 1.0 or np.any(got[mask == 0] != 0.0):
        fail(f"{path} leaves [0,1] or is nonzero outside the brain mask")
    return list(got.shape)


def phase_synthesis(torch, tmp: str) -> tuple[dict, dict]:
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, sample
    from fast_cwdm_tpu_torch.data import brats

    cfg, sd = seeded_production(torch, fuse_gn_silu=True)
    weights = os.path.join(tmp, "brats_t1c_BEST_sampled_10.pt")
    torch.save(sd, weights)
    case = os.path.join(tmp, "data", "00001")
    write_case(case)
    out_dir = os.path.join(tmp, "out")
    flags = [f"--{k}={v}" for k, v in cfg.items()] + [
        f"--data_dir={os.path.dirname(case)}", f"--model_path={weights}",
        "--contr=t1c", f"--output_dir={out_dir}", "--seed=0",
    ]

    mask = brats.load_preprocessed(os.path.join(case, "BraTS-GLI-00001-000-t1n.nii.gz"))
    mask = mask[..., 0][:, :, :155]

    # main path 1: ddpm, every GN→SiLU through K3
    reset_counts()
    timings = sample.main(flags)  # through the user's entry point
    torch.cuda.synchronize()
    counts = read_counts()
    res = {"sample_shape": check_sample(np, os.path.join(out_dir, "00001", "sample.nii.gz"), mask),
           "s_per_volume_cli_first_case": timings[0], "launches": counts,
           "graph": check_graph_counts(volumes=1)}
    if counts["haar_dwt3"] < 3 or counts["haar_idwt3"] < 1 or counts["affine_silu"] != 71 * 10 \
            or counts["gn_stats"] != 71 * 10:
        fail(f"the main path did not run through every kernel: {counts}")

    # main path 2: every non-up/down ResBlock's two convs through K4b
    # (27 × 2 per forward), DPM-Solver++ with 10 evaluations; as
    # ``bench.py --fused --dpm 10`` (fuse_conv without fuse_gn_silu)
    conv_dir = os.path.join(tmp, "out_fuse_conv")
    reset_counts()
    timings = sample.main(flags + [f"--output_dir={conv_dir}", "--fuse_gn_silu=False",
                                   "--fuse_conv=True", "--sampler=dpm++", "--sampling_steps=10"])
    torch.cuda.synchronize()
    conv_counts = read_counts()
    res["fuse_conv_dpm"] = {
        "sample_shape": check_sample(np, os.path.join(conv_dir, "00001", "sample.nii.gz"), mask),
        "s_per_volume_cli_first_case": timings[0], "launches": conv_counts}
    # by kernel: what route() gives the 54 production convs, × 10
    # evaluations; levels 0 and 1 (20 sites) must be among the wgmma ones,
    # levels 3 and 4 (24 sites) on split-K, no bf16 conv on mma.sync
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    routes = {shape: tc.route(torch.bfloat16, 1, shape[1], shape[2], *shape[0])
              for shape in PRODUCTION_CONVS}
    want = {k: 10 * sum(n for shape, n in PRODUCTION_CONVS.items() if routes[shape] == k)
            for k in CONV_KERNELS}
    res["fuse_conv_dpm"]["launches_expected_by_kernel"] = want
    if (conv_counts["conv3d_fused_k4b"] != 54 * 10 or conv_counts["conv3d_fused_k4a"]
            or conv_counts["conv3d_fused_v4"] or conv_counts["haar_dwt3"] < 3
            or conv_counts["haar_idwt3"] != 1
            or any(conv_counts[f"conv3d_{k}"] != n for k, n in want.items())
            or want["mma_sync"] or want["wgmma_n32"]
            or any(routes[shape] != "wgmma" for shape in PRODUCTION_CONVS if shape[0][0] >= 56)
            or any(routes[shape] != "splitk" for shape in PRODUCTION_CONVS if shape[0][0] <= 14)):
        fail(f"the fused-conv path did not run through its kernels as expected: {conv_counts}")

    res["fuse_conv_dpm"]["graph"] = check_graph_counts(volumes=1)
    res.update(phase_synthesis_fn(torch, np, cfg, sd, case))
    return res, counts, conv_counts


def check_graph_counts(volumes: int, steps: int = 10) -> dict:
    """Graphs captured and replayed since the last reset_counts: a CLI run
    of one model over ``volumes`` volumes of a ``steps``-step chain captures
    one step (after two eager warm-up steps) and replays it for every other
    step."""
    from fast_cwdm_tpu_torch.diffusion import graph

    want = {"captures": 1, "replays": volumes * steps - 2}
    if graph.counts != want:
        fail(f"the run did not go through the captured chain: {graph.counts}, expected {want}")
    return dict(graph.counts)


# name: (model flags, sampler, diffusion fields replaced). "faithful" is
# bench.py's faithful leg: fp32, unfused, the reference's IDWT → clamp →
# DWT every step (K2 → clamp → K1); "fp32" the same chain with the fused
# projection; "fp32_fuse_conv" the "fp32" chain with every ResBlock conv
# through K4b in fp32 (on the 3×TF32 kernel). All three run
# with TF32 off and cuDNN deterministic.
SYNTH_VARIANTS = {"unfused": ({}, "ddpm", {}), "fused": (dict(fuse_gn_silu=True), "ddpm", {}),
                  "fuse_conv_ddpm": (dict(fuse_conv=True), "ddpm", {}),
                  "fuse_conv_dpm": (dict(fuse_conv=True), "dpm++", {}),
                  "fp32": (dict(dtype="float32"), "ddpm", {}),
                  "faithful": (dict(dtype="float32"), "ddpm", dict(fuse_clip_projection=False)),
                  "fp32_fuse_conv": (dict(dtype="float32", fuse_conv=True), "ddpm", {}),
                  "fp32_fuse_conv_ffma": (dict(dtype="float32", fuse_conv=True), "ddpm", {})}
FP32_VARIANTS = ("fp32", "faithful", "fp32_fuse_conv", "fp32_fuse_conv_ffma")
# run inside fp32_on_conv3d_cu: the fp32 fuse_conv chain on conv3d.cu's FFMA
# path, the yardstick of the 3×TF32 kernel's image
FFMA_VARIANTS = ("fp32_fuse_conv_ffma",)
# launches per volume of each variant on the graph path: K1 3 (condition)
# and K2 1 (output) a volume, and with the unfused projection one K2 and
# one K1 more for each of the 10 steps; GroupNorm's statistics kernel at
# the 71 GroupNorms of every forward
SYNTH_WANT = {"unfused": {"gn_stats": 710, "affine_silu": 0, "conv3d_fused_k4b": 0},
              "fused": {"gn_stats": 710, "affine_silu": 710, "conv3d_fused_k4b": 0},
              "fuse_conv_ddpm": {"gn_stats": 710, "affine_silu": 0, "conv3d_fused_k4b": 540,
                                 "conv3d_wgmma": 300, "conv3d_wgmma_n32": 0,
                                 "conv3d_splitk": 240, "conv3d_mma_sync": 0},
              "fuse_conv_dpm": {"gn_stats": 710, "affine_silu": 0, "conv3d_fused_k4b": 540,
                                "conv3d_wgmma": 300, "conv3d_wgmma_n32": 0,
                                "conv3d_splitk": 240, "conv3d_mma_sync": 0},
              "fp32": {"gn_stats": 710, "haar_dwt3": 3, "haar_idwt3": 1, "affine_silu": 0,
                       "conv3d_fused_k4b": 0},
              "faithful": {"gn_stats": 710, "haar_dwt3": 3 + 10, "haar_idwt3": 1 + 10,
                           "affine_silu": 0, "conv3d_fused_k4b": 0},
              # every level's convs (54 a forward) on the 3×TF32 kernel
              "fp32_fuse_conv": {"gn_stats": 710, "haar_dwt3": 3, "haar_idwt3": 1,
                                 "affine_silu": 0, "conv3d_fused_k4b": 540,
                                 "conv3d_wgmma_tf32": 540, "conv3d_mma_sync": 0,
                                 "conv3d_wgmma": 0, "conv3d_wgmma_n32": 0, "conv3d_splitk": 0},
              "fp32_fuse_conv_ffma": {"gn_stats": 710, "haar_dwt3": 3, "haar_idwt3": 1,
                                      "affine_silu": 0, "conv3d_fused_k4b": 540,
                                      "conv3d_wgmma_tf32": 0, "conv3d_mma_sync": 540}}


def phase_synthesis_fn(torch, np, cfg, sd, case) -> dict:
    """``make_synthesis_fn`` on the case, the variants of
    ``SYNTH_VARIANTS``, each eager (``cuda_graph=False``) and graphed: one
    warm-up call each (the graph's capture), then one timed call each, on
    one generator seed; host clock from the condition DWTs to the image on
    the host. The graph path's image against the eager one (expected bit
    for bit, and held so in fp32), its launches per volume, its capture
    seconds and pool memory; the faithful leg's image against the fused
    projection's (1e-4), and the fp32 fuse_conv image against the unfused
    fp32 one (1e-4). Then one ``devtime``
    trace of the fuse_conv dpm++ synthesis, eager and graphed (device ms,
    wall ms, busy share); and a 100-step fuse_conv ddpm chain, graphed, with
    ``chunk=None`` and ``chunk=32`` (a ragged last segment of 4)."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.data import brats
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    item = brats.BRATSVolumes(os.path.dirname(case))[0]
    batch = {m: item[m][None] for m in brats.MODALITIES}
    runs, models, variant = {}, {}, {}
    for name, (flags_v, sampler, changes) in SYNTH_VARIANTS.items():
        m, diff = common.build_model_and_diffusion({**cfg, "fuse_gn_silu": False, **flags_v})
        m.load_state_dict(sd)
        diff = diff.replace(**changes)
        models[name] = (m, diff)
        for path in ("eager", "graph"):
            runs[f"{name}_{path}"] = common.make_synthesis_fn(
                m, diff, sampler=sampler, sampler_steps=10, device="cuda",
                cuda_graph=path == "graph")
            variant[f"{name}_{path}"] = name
    names = list(runs)
    order = names + names[::-1]
    times, imgs, launches = {name: [] for name in names}, {}, {}
    for k, name in enumerate(order):
        gen = torch.Generator(device="cuda").manual_seed(0)
        reset_counts()
        exact = no_tf32(torch, deterministic=True)
        ffma = (fp32_on_conv3d_cu(torch, tc) if variant[name] in FFMA_VARIANTS else
                contextlib.nullcontext())
        with exact if variant[name] in FP32_VARIANTS else contextlib.nullcontext(), ffma:
            t0 = time.perf_counter()
            cond = common.prepare_condition(batch, "t1c", device="cuda")
            img = runs[name](cond, batch["t1n"], gen)
            seconds = time.perf_counter() - t0
        launches[name] = read_counts()
        if k < len(names):
            imgs[name] = img
        else:
            times[name].append(seconds)
            if not np.array_equal(img, imgs[name]):
                fail(f"{name}: a second call on the same seed gave another image")
    res = {}
    for name in names:
        res[f"s_per_volume_{name}"] = statistics.median(times[name])
        res[f"s_per_volume_{name}_all"] = times[name]
    bad = []
    for name in SYNTH_VARIANTS:
        e, g = imgs[f"{name}_eager"], imgs[f"{name}_graph"]
        step = runs[f"{name}_graph"].chain.graph
        res[f"graph_{name}"] = {
            "max_abs_diff_image_graph_vs_eager": float(np.abs(g - e).max()),
            "n_differ": int((g != e).sum()),
            "launches_per_volume": launches[f"{name}_graph"],
            "launches_per_volume_eager": launches[f"{name}_eager"],
            "launches_per_replay": step.launches_per_replay,
            "capture_s": step.capture_seconds, "pool_bytes_added": step.pool_bytes}
        want = SYNTH_WANT[name]
        if any(launches[f"{name}_graph"][k] != n for k, n in want.items()) \
                or launches[f"{name}_graph"] != launches[f"{name}_eager"] \
                or float(np.abs(g - e).max()) > 1e-4 \
                or (name in FP32_VARIANTS and res[f"graph_{name}"]["n_differ"]):
            bad.append(name)
    res["graph_pool_bytes_added_total"] = sum(
        runs[f"{n}_graph"].chain.graph.pool_bytes for n in SYNTH_VARIANTS)
    a = imgs["unfused_eager"]
    for name in ("fused", "fuse_conv_ddpm"):
        res[f"max_abs_diff_image_{name}_vs_unfused"] = float(np.abs(imgs[f"{name}_eager"] - a).max())
        res[f"mean_abs_diff_image_{name}_vs_unfused"] = float(np.abs(imgs[f"{name}_eager"] - a).mean())
    # the faithful leg against the fused projection: same weights and noise
    diff = np.abs(imgs["faithful_graph"] - imgs["fp32_graph"])
    res["faithful"] = {
        "max_abs_diff_image_vs_fused_projection": float(diff.max()),
        "mean_abs_diff_image_vs_fused_projection": float(diff.mean()), "tol": 1e-4,
        "finite_in_unit_range": bool(np.isfinite(imgs["faithful_graph"]).all()
                                     and 0.0 <= imgs["faithful_graph"].min()
                                     and imgs["faithful_graph"].max() <= 1.0),
        "max_image": float(imgs["faithful_graph"].max())}
    if not (res["faithful"]["max_abs_diff_image_vs_fused_projection"] <= 1e-4
            and res["faithful"]["finite_in_unit_range"] and res["faithful"]["max_image"] > 0):
        fail(f"the faithful leg disagrees with the fused projection: {res['faithful']}")
    # the fp32 fuse_conv chain, on the 3×TF32 kernel and on conv3d.cu's
    # FFMA path, against the unfused fp32 chain (cuDNN fp32) and each other:
    # same weights and noise, the convs on other kernels
    for name in ("fp32_fuse_conv", "fp32_fuse_conv_ffma"):
        img = imgs[f"{name}_graph"]
        diff = np.abs(img - imgs["fp32_graph"])
        res[name] = {
            "max_abs_diff_image_vs_fp32": float(diff.max()),
            "mean_abs_diff_image_vs_fp32": float(diff.mean()), "tol": 1e-4,
            "finite_in_unit_range": bool(np.isfinite(img).all() and 0.0 <= img.min()
                                         and img.max() <= 1.0),
            "max_image": float(img.max())}
        if not (res[name]["max_abs_diff_image_vs_fp32"] <= 1e-4
                and res[name]["finite_in_unit_range"] and res[name]["max_image"] > 0):
            fail(f"the {name} chain disagrees with the unfused fp32 one: {res[name]}")
    res["fp32_fuse_conv"]["max_abs_diff_image_vs_ffma"] = float(
        np.abs(imgs["fp32_fuse_conv_graph"] - imgs["fp32_fuse_conv_ffma_graph"]).max())
    if bad:
        fail(f"the graphed synthesis disagrees with the eager one or with the expected "
             f"launches: {bad}: { {k: v for k, v in res.items() if k.startswith('graph_')} }")

    # one traced 10-evaluation fuse_conv dpm++ synthesis on each path
    cond = common.prepare_condition(batch, "t1c", device="cuda")
    res["devtime_fuse_conv_dpm"] = {
        path: devtime(lambda: runs[f"fuse_conv_dpm_{path}"](
            cond, batch["t1n"], torch.Generator(device="cuda").manual_seed(0)), iters=1)
        for path in ("eager", "graph")}

    # a 100-step ddpm chain, graphed, unchunked and in segments of 32
    m, _ = models["fuse_conv_ddpm"]
    d100 = GaussianDiffusion.named("linear", 100, "sampled", mode="i2i")
    chunked = {}
    for chunk in (None, 32):
        run = common.make_synthesis_fn(m, d100, chunk=chunk, device="cuda")
        t0 = time.perf_counter()
        chunked[chunk] = run(cond, batch["t1n"], torch.Generator(device="cuda").manual_seed(0))
        res[f"s_100_steps_chunk_{chunk}"] = time.perf_counter() - t0
        res[f"s_100_steps_chunk_{chunk}_capture_s"] = run.chain.graph.capture_seconds
        del run
    res["max_abs_diff_100_steps_chunk_none_vs_32"] = float(np.abs(chunked[None] - chunked[32]).max())
    if res["max_abs_diff_100_steps_chunk_none_vs_32"] != 0.0:
        fail(f"the 100-step chain differs between chunk None and 32: {res}")
    del runs, models
    torch.cuda.empty_cache()
    return res


def image_sha256(np, vol) -> str:
    """sha256 of a volume's voxels (C order, its own dtype): the image,
    not the file, whose gzip header carries a time."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(vol).tobytes()).hexdigest()


def same_tree(np, a, b) -> bool:
    """Two nested dicts of numpy arrays equal key for key, bit for bit."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            same_tree(np, a[k], b[k]) for k in b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def check_synthesized(np, src: str, out_path: str, case: str, mask_mod: str = "t1n") -> dict:
    """A synthesized volume at the source's shape and affine, finite, in
    [0,1], zero outside the brain mask (of ``mask_mod``, the first condition
    modality) and in the 8-voxel X/Y border."""
    from fast_cwdm_tpu_torch.data import brats, nifti

    t1n = os.path.join(src, f"BraTS-GLI-{case}-000-{mask_mod}.nii.gz")
    head = nifti.load_header(t1n)
    img = nifti.load(out_path)
    vol = img.get_fdata()
    mask = brats.unprocess_volume(brats.load_preprocessed(t1n)[..., 0][:, :, :155],
                                  raw_shape=head.shape)
    if vol.shape != (240, 240, 155) or head.shape != vol.shape or not np.array_equal(img.affine, head.affine):
        fail(f"{case}: synthesized {vol.shape} with affine {img.affine.tolist()}, source {head.shape}")
    if not np.isfinite(vol).all() or vol.min() < 0.0 or vol.max() > 1.0:
        fail(f"{case}: the synthesized volume is not finite in [0, 1]")
    if np.any(vol[mask == 0] != 0.0) or vol[:8].any() or vol[-8:].any() or vol[:, :8].any() \
            or vol[:, -8:].any():
        fail(f"{case}: the synthesized volume is nonzero outside the brain mask or in the border")
    return {"shape": list(vol.shape), "max": float(vol.max()), "nonzero": int((vol > 0).sum())}


def check_completed(np, in_dir: str, out_dir: str, case: str, missing: str | None) -> dict:
    """One output case of complete_dataset: all four modalities, every
    present file byte-identical to its input, the synthesized one checked by
    check_synthesized; a complete case passed through as it was."""
    import filecmp

    from fast_cwdm_tpu_torch.data import brats

    src, out = os.path.join(in_dir, case), os.path.join(out_dir, case)
    names = sorted(os.listdir(out))
    if any(not any(f"-{m}." in n for n in names) for m in brats.MODALITIES):
        fail(f"{out} lacks a modality: {names}")
    for n in os.listdir(src):
        if not filecmp.cmp(os.path.join(src, n), os.path.join(out, n), shallow=False):
            fail(f"{out}/{n} differs from its input")
    if missing is None:
        if names != sorted(os.listdir(src)):
            fail(f"the complete case {case} was not passed through as it was: {names}")
        return {"passed_through": names}
    from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order

    return check_synthesized(np, src, os.path.join(out, f"{case}-{missing}.nii.gz"), case,
                             mask_mod=condition_order(missing)[0])


# every launch counter but K1's and K2's, at 0: a path that launches none
# of K3, its VJP or the fused conv
IDLE = {"affine_silu": 0, "affine_silu_bwd": 0, "conv3d_fused_k4a": 0, "conv3d_fused_k4b": 0,
        "conv3d_fused_v4": 0, "conv3d_wgmma": 0, "conv3d_wgmma_n32": 0, "conv3d_splitk": 0,
        "conv3d_mma_sync": 0}


def phase_completion(torch, tmp: str) -> dict:
    """The production weights as a JAX-layout ``.ckpt`` (one EMA shadow equal
    to the params, a sidecar as the JAX package writes it), written and read
    back bit for bit; then ``cli.complete_dataset`` on the card over two
    240×240×155 cases without t1c and one complete case, (a) with the
    sidecar as written (unfused ddpm: 3 K1 + 1 K2 per case), (b) with
    ``fuse_conv: true`` added and ``--sampler dpm++ --sampling_steps 10``
    (540 K4b per case: 300 wgmma, 240 split-K); then ``cli.sample_auto`` on
    the same tree with the sidecar as written."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, complete_dataset, sample_auto
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.training import checkpoints

    cfg, sd = seeded_production(torch)
    model, _ = common.build_model_and_diffusion(cfg)
    params = jax_params_from_state_dict(sd, model)
    ckpt_dir = os.path.join(tmp, "ckpt")
    path = os.path.join(ckpt_dir, "brats_t1c_BEST_sampled_10.ckpt")
    sidecar = {k: v for k, v in cfg.items() if k not in ("fuse_gn_silu", "fuse_conv")}
    sidecar.update(contr="t1c")
    t0 = time.perf_counter()
    checkpoints.save_checkpoint(path, {"params": params, "ema_params": (params,), "step": 0}, sidecar)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = checkpoints.load_with_ema_probe(path)
    read_s = time.perf_counter() - t0
    if not (same_tree(np, loaded["params"], params) and len(loaded["ema_params"]) == 1
            and same_tree(np, loaded["ema_params"][0], params)):
        fail("the production .ckpt did not read back bit for bit")
    common.load_params(path, model, use_ema=True)
    if any(not torch.equal(model.state_dict()[k], v) for k, v in sd.items()):
        fail("the production .ckpt did not load into the model bit for bit")
    del model, loaded, params
    res = {"ckpt": {"bytes": os.path.getsize(path), "write_s": write_s, "read_s": read_s,
                    "n_params": sum(v.numel() for v in sd.values())}}

    in_dir = os.path.join(tmp, "complete_in")
    cases = {"00001": "t1c", "00002": "t1c", "00003": None}
    for k, (case, missing) in enumerate(cases.items()):
        write_case(os.path.join(in_dir, case), seed=k)
        if missing:
            os.remove(os.path.join(in_dir, case, f"BraTS-GLI-{case}-000-{missing}.nii.gz"))
    n_synth = sum(m is not None for m in cases.values())

    def run(name, main, argv, want):
        out_dir = os.path.join(tmp, name)
        reset_counts()
        got = main(argv + [f"--output_dir={out_dir}"])
        torch.cuda.synchronize()
        counts = read_counts()
        bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
        if bad:
            fail(f"{name}: launches (got, expected) {bad}; all counts {counts}")
        counts["graph"] = check_graph_counts(volumes=n_synth)
        return out_dir, got, counts

    flags = [f"--input_dir={in_dir}", f"--checkpoint_dir={ckpt_dir}", "--seed=0"]
    haar = {"haar_dwt3": 3 * n_synth, "haar_idwt3": n_synth}
    runs = {
        "complete_a": ([], dict(IDLE, **haar)),
        "complete_b": (["--sampler=dpm++", "--sampling_steps=10"],
                       dict(IDLE, **haar, conv3d_fused_k4b=540 * n_synth,
                            conv3d_wgmma=300 * n_synth, conv3d_splitk=240 * n_synth)),
    }
    vols = {}
    for name, (extra, want) in runs.items():
        if name == "complete_b":  # a sidecar that routes every ResBlock conv through K4b
            with open(path + ".json", "w") as f:
                json.dump(dict(sidecar, fuse_conv=True), f, indent=2)
        out_dir, got, counts = run(name, complete_dataset.main, flags + extra, want)
        if got["failed"] or sorted(got["seconds"]) != sorted(c for c, m in cases.items() if m):
            fail(f"{name}: {got}")
        checked = {case: check_completed(np, in_dir, out_dir, case, m) for case, m in cases.items()}
        res[name] = {"s_per_case": got["seconds"], "failed": got["failed"], "launches": counts,
                     "launches_expected": want, "outputs": checked}
        vols[name] = {case: nifti.load(os.path.join(out_dir, case, f"{case}-{m}.nii.gz")).dataobj
                      for case, m in cases.items() if m}
        res[name]["sha256"] = {c: image_sha256(np, v) for c, v in vols[name].items()}
    res["max_abs_diff_a_vs_b"] = max(float(np.abs(vols["complete_a"][c] - vols["complete_b"][c]).max())
                                     for c in vols["complete_a"])
    res["volumes_differ_a_vs_b"] = res["max_abs_diff_a_vs_b"] > 0.0

    # sample_auto: the sidecar as written, bf16, ddpm
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    out_dir, got, counts = run("sample_auto", sample_auto.main,
                               [f"--data_dir={in_dir}", f"--checkpoint_dir={ckpt_dir}",
                                "--dtype=bfloat16"], dict(IDLE, **haar))
    if (got["done"], got["skipped"], got["failed"]) != (n_synth, len(cases) - n_synth, 0) \
            or sorted(os.listdir(out_dir)) != sorted(c for c, m in cases.items() if m):
        fail(f"sample_auto: {got}, wrote {sorted(os.listdir(out_dir))}")
    res["sample_auto"] = {"s_per_case": got["seconds"], "launches": counts, "outputs": {
        case: check_synthesized(np, os.path.join(in_dir, case),
                                os.path.join(out_dir, case, f"{case}-{m}.nii.gz"), case)
        for case, m in cases.items() if m}}
    return res


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def fixture_values(np, prefix: str) -> tuple[dict, set]:
    """``tests/golden/orbax_tiny.npz``: the leaves of one fixture
    (``{"a/b": array}``, bfloat16 leaves as their int16 bits under
    ``"a/b@bfloat16"``) and the paths of its empty nodes."""
    with np.load(os.path.join(REPO, "tests", "golden", "orbax_tiny.npz")) as z:
        leaves = {k[len(prefix) + 1:]: z[k] for k in z.files
                  if k.startswith(prefix + ":") and k != f"{prefix}:empty"}
        return leaves, set(z[f"{prefix}:empty"].tolist())


def check_fixture(torch, np, path: str, prefix: str) -> dict:
    """A committed tensorstore-written ``.orbax`` read by the port equals
    its ``.npz`` bit for bit (leaves, dtypes, shapes, empty nodes)."""
    from fast_cwdm_tpu_torch.training import checkpoints

    t0 = time.perf_counter()
    tree = checkpoints.load_checkpoint(path)
    seconds = time.perf_counter() - t0
    want, empty = fixture_values(np, prefix)
    got, got_empty = {}, set()

    def walk(node, key):
        if isinstance(node, dict):
            if not node:
                got_empty.add(key)
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else k)
        elif isinstance(node, torch.Tensor):
            got[key + "@bfloat16"] = node.view(torch.int16).numpy()
        else:
            got[key] = node

    walk(tree, "")
    bad = sorted(k for k in set(want) | set(got) if k not in want or k not in got
                 or want[k].dtype != got[k].dtype or want[k].shape != got[k].shape
                 or want[k].tobytes() != got[k].tobytes())
    if bad or got_empty != empty:
        fail(f"{path} differs from its .npz: {bad[:5]}, empty {sorted(got_empty ^ empty)}")
    return {"leaves": len(got), "bytes": dir_bytes(path), "read_s": seconds}


def snapshot_state(loop) -> dict:
    """A TrainLoop's parameters, EMA shadows, Adam moments and count, on the
    host."""
    st = loop.state
    cpu = lambda d: {k: v.detach().float().cpu().clone() for k, v in d.items()}  # noqa: E731
    return {"params": cpu(st.params), "ema": [cpu(e) for e in st.ema_params],
            "mu": cpu(st.opt_state["mu"]), "nu": cpu(st.opt_state["nu"]),
            "count": int(st.opt_state["count"])}


def same_state(torch, a: dict, b: dict) -> bool:
    same = lambda x, y: x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)  # noqa: E731
    return (same(a["params"], b["params"]) and same(a["mu"], b["mu"])
            and same(a["nu"], b["nu"]) and a["count"] == b["count"]
            and len(a["ema"]) == len(b["ema"]) and all(map(same, a["ema"], b["ema"])))


def phase_orbax(torch, tmp: str, comp: dict) -> dict:
    """The main path from ``.orbax``: (a) the seeded production weights with
    one EMA shadow written by the port as an Orbax directory with its
    sidecar and read back bit for bit; (b) the committed fixtures written
    by the JAX package through tensorstore, read without it, equal to their
    ``.npz``; (c) ``cli.complete_dataset`` from (a)'s ``.orbax`` with
    ``fuse_conv`` and dpm++ 10 over phase completion's two cases and
    seeds: the same images as its run (b) from the ``.ckpt``, by sha256,
    540 K4b per case (300 wgmma, 240 split-K), through the captured chain;
    (d) ``cli.train`` with ``--fuse_gn_silu=True`` under
    ``FAST_CWDM_CKPT_BACKEND=orbax``, 3 steps (every file an Orbax
    directory), its step checkpoint written as a preemption writes it,
    then one more step resumed from it: the opt blob it names, and the
    state restored equal to the state written, bit for bit."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, complete_dataset
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.training import checkpoints
    from fast_cwdm_tpu_torch.training.loop import TrainLoop

    # (a)
    cfg, sd = seeded_production(torch)
    model, _ = common.build_model_and_diffusion(cfg)
    params = jax_params_from_state_dict(sd, model)
    ckpt_dir = os.path.join(tmp, "ckpt")
    path = os.path.join(ckpt_dir, "brats_t1c_BEST_sampled_10.orbax")
    sidecar = {k: v for k, v in cfg.items() if k not in ("fuse_gn_silu", "fuse_conv")}
    sidecar.update(contr="t1c", fuse_conv=True)
    t0 = time.perf_counter()
    checkpoints.save_checkpoint(path, {"params": params, "ema_params": (params,), "step": 0},
                                sidecar)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = checkpoints.load_with_ema_probe(path)
    read_s = time.perf_counter() - t0
    if not (os.path.isdir(path) and checkpoints.load_checkpoint_config(path) == sidecar
            and same_tree(np, loaded["params"], params) and len(loaded["ema_params"]) == 1
            and same_tree(np, loaded["ema_params"][0], params)):
        fail("the production .orbax did not read back bit for bit")
    common.load_params(path, model, use_ema=True)
    if any(not torch.equal(model.state_dict()[k], v) for k, v in sd.items()):
        fail("the production .orbax did not load into the model bit for bit")
    del model, loaded, params
    res = {"production": {"bytes": dir_bytes(path), "write_s": write_s, "read_s": read_s,
                          "ckpt": comp["ckpt"]}}

    # (b)
    golden = os.path.join(REPO, "tests", "golden")
    res["fixtures"] = {name: check_fixture(torch, np, os.path.join(golden, name), prefix)
                       for name, prefix in (("orbax_tiny.orbax", "ckpt"),
                                            ("opt_tiny.orbax", "opt"))}

    # (c)
    in_dir = os.path.join(tmp, "complete_in")
    cases = {"00001": "t1c", "00002": "t1c", "00003": None}  # phase completion's
    for k, (case, missing) in enumerate(cases.items()):
        write_case(os.path.join(in_dir, case), seed=k)
        if missing:
            os.remove(os.path.join(in_dir, case, f"BraTS-GLI-{case}-000-{missing}.nii.gz"))
    n_synth = sum(m is not None for m in cases.values())
    want = dict(IDLE, haar_dwt3=3 * n_synth, haar_idwt3=n_synth,
                conv3d_fused_k4b=540 * n_synth, conv3d_wgmma=300 * n_synth,
                conv3d_splitk=240 * n_synth)
    out_dir = os.path.join(tmp, "complete_out")
    reset_counts()
    got = complete_dataset.main([f"--input_dir={in_dir}", f"--checkpoint_dir={ckpt_dir}",
                                 "--seed=0", "--sampler=dpm++", "--sampling_steps=10",
                                 f"--output_dir={out_dir}"])
    torch.cuda.synchronize()
    counts = read_counts()
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if bad or got["failed"] or sorted(got["seconds"]) != sorted(c for c, m in cases.items() if m):
        fail(f"complete_dataset from .orbax: launches (got, expected) {bad}, {got}")
    sha = {case: image_sha256(np, nifti.load(os.path.join(out_dir, case, f"{case}-{m}.nii.gz")).dataobj)
           for case, m in cases.items() if m}
    if sha != comp["complete_b"]["sha256"]:
        fail(f"complete_dataset from .orbax: images {sha} differ from the .ckpt run's "
             f"{comp['complete_b']['sha256']}")
    res["complete"] = {"s_per_case": got["seconds"], "launches": counts,
                       "launches_per_case": {k: v // n_synth for k, v in counts.items()},
                       "graph": check_graph_counts(volumes=n_synth), "sha256": sha,
                       "outputs": {case: check_completed(np, in_dir, out_dir, case, m)
                                   for case, m in cases.items()}}

    # (d)
    data = os.path.join(tmp, "data")
    for k in range(2):
        write_case(os.path.join(data, f"0000{k + 1}"), seed=10 + k)
    os.environ["OPENAI_LOGDIR"] = log_dir = os.path.join(tmp, "log")
    os.environ["OPENAI_LOG_FORMAT"] = "log,csv"
    train_dir = os.path.join(tmp, "ckpt_train")
    n = 3
    per_step = {"haar_dwt3": 5, "haar_idwt3": 1, "affine_silu": 71 + REMAT_GN_SITES,
                "affine_silu_bwd": 71, "conv3d_fused_k4b": 0}
    states = {}

    def preemption_save(loop):  # what SIGTERM makes the loop write
        loop.save(n)
        states["written"] = snapshot_state(loop)

    orig = TrainLoop._apply_resume

    def spy(self):
        orig(self)
        states["restored"] = snapshot_state(self)
        states["resume_step"] = self.resume_step

    os.environ["FAST_CWDM_CKPT_BACKEND"] = "orbax"
    TrainLoop._apply_resume = spy
    try:
        first = run_train(torch, tmp, "orbax_train",
                          train_flags(data, train_dir, n, fuse_gn_silu=True), n,
                          on_done=preemption_save)
        files = sorted(os.listdir(train_dir))
        step_ckpt = os.path.join(train_dir, checkpoints.step_checkpoint_name(
            "t1c", n, "sampled", 10))
        opt_blob = checkpoints.opt_checkpoint_name("t1c", n, "sampled", 10)
        resumed = run_train(torch, tmp, "orbax_resume",
                            train_flags(data, train_dir, n + 1, fuse_gn_silu=True)
                            + [f"--resume_checkpoint={step_ckpt}"], 1)
    finally:
        TrainLoop._apply_resume = orig
        del os.environ["FAST_CWDM_CKPT_BACKEND"]
    blobs = [f for f in files if not f.endswith((".json", ".txt"))]
    expected = sorted(["brats_t1c_BEST_sampled_10.orbax", "opt_best_t1c.orbax",
                       os.path.basename(step_ckpt), opt_blob])
    if blobs != expected or not all(checkpoints.is_orbax_checkpoint(os.path.join(train_dir, f))
                                    and os.path.isdir(os.path.join(train_dir, f)) for f in blobs):
        fail(f"cli.train under FAST_CWDM_CKPT_BACKEND=orbax wrote {files}, expected {expected}")
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    if f"restored the optimizer state from {os.path.join(train_dir, opt_blob)}" not in log:
        fail(f"the resumed run does not name its .orbax opt blob {opt_blob}")
    if states.get("resume_step") != n or not same_state(torch, states["written"],
                                                        states["restored"]):
        fail("the state restored from the .orbax step checkpoint differs from the state written")
    for name, r in (("orbax_train", first), ("orbax_resume", resumed)):
        bad = {k: (r["launches_per_step"][k], v) for k, v in per_step.items()
               if r["launches_per_step"][k] != v}
        if bad:
            fail(f"{name}: launches per step (got, expected) {bad}")
    del states
    res["train"] = {"files": files, "opt_blob_resumed": opt_blob, "restored_bit_for_bit": True,
                    "first": {k: first[k] for k in ("s_per_step_warm", "losses", "launches_per_step")},
                    "resumed": {k: resumed[k] for k in ("s_per_step_all", "losses",
                                                        "launches_per_step")}}
    return res


# (channels, spatial) of every GN+SiLU site of the production UNet, with
# its count per forward (71 in all; models/unet.py on the meta device)
GN_SITES = {
    (64, (112, 112, 80)): 9, (128, (112, 112, 80)): 3, (192, (112, 112, 80)): 1,
    (64, (56, 56, 40)): 2, (128, (56, 56, 40)): 9, (192, (56, 56, 40)): 1,
    (256, (56, 56, 40)): 2, (128, (28, 28, 20)): 10, (256, (28, 28, 20)): 3,
    (384, (28, 28, 20)): 1, (128, (14, 14, 10)): 2, (256, (14, 14, 10)): 9,
    (384, (14, 14, 10)): 1, (512, (14, 14, 10)): 2, (256, (7, 7, 5)): 13,
    (512, (7, 7, 5)): 3,
}
VJP_TOL = ("gx: 0 (bit for bit, the same fp32 operations each rounded once); ga, gb: "
           "1e-5 of the sum of the terms' magnitudes (summation order)")
TRAIN_STEPS = 4  # optimizer steps of each cli.train run
# the ResBlocks use_checkpoint recomputes at ds <= 1 (remat_max_ds's
# default): level 0's two ResBlocks and its down block, and the decoder's
# three level-0 ResBlocks; two GN+SiLU sites each
REMAT_GN_SITES = 12


def vjp_ratio(torch, ec, got, ref, x, g, a, b) -> float:
    """The VJP kernel's worst tolerance ratio (≤ 1 passes): gx must equal
    the plain version's; ga and gb within 1e-5 of Σ|du·x| and Σ|du|."""
    gx, ga, gb = got
    rx, ra, rb = ref
    if not torch.equal(gx, rx):
        return float("inf")
    _, ta, tb = ec.affine_silu_bwd_plain(x.abs(), g.abs(), a.abs(), b.abs())
    return max(float(((ga - ra).abs() / (1e-5 * ta + 1e-30)).max()),
               float(((gb - rb).abs() / (1e-5 * tb + 1e-30)).max()))


def phase_vjp_kernel(torch) -> dict:
    """The K3 VJP kernel at every distinct GN+SiLU shape of the production
    UNet, bf16 channels_last_3d (the training path) and fp32 contiguous:
    against affine_silu_bwd_plain, and a second launch bit for bit; then its
    time per shape (bf16 channels_last_3d, median, L2 flushed) and per train
    step (71 sites), the bound, and the plain version's time at level 0."""
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec

    g = torch.Generator(device="cuda").manual_seed(7)
    checks, worst_err, worst_ratio, per_shape = [], 0.0, 0.0, []
    step_ms = step_bound = 0.0
    for (c, sp), n in GN_SITES.items():
        for dtype, fmt in ((torch.bfloat16, "channels_last_3d"), (torch.float32, "contiguous")):
            x = torch.randn((1, *sp, c), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
            gr = torch.randn((1, *sp, c), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
            if fmt == "contiguous":
                x, gr = x.contiguous(), gr.contiguous()
            a = torch.randn((1, c), generator=g, device="cuda")
            b = torch.randn((1, c), generator=g, device="cuda")
            got = ec.affine_silu_bwd(x, gr, a, b)
            again = ec.affine_silu_bwd(x, gr, a, b)
            ref = ec.affine_silu_bwd_plain(x, gr, a, b)
            ratio = vjp_ratio(torch, ec, got, ref, x, gr, a, b)
            err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(got, ref))
            twice = all(torch.equal(o, p) for o, p in zip(got, again))
            checks.append(dict(c=c, spatial=list(sp), dtype=str(dtype).split(".")[-1], format=fmt,
                               plan=list(ec.bwd_plan(x, gr, got[0])), max_abs_err=err,
                               tol_ratio=ratio, gx_n_differ=int((got[0] != ref[0]).sum()),
                               bit_identical_twice=twice))
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
            if dtype == torch.bfloat16:
                nb = 3 * x.numel() * 2 + 4 * a.numel() * 4
                b_ms, b_by = bound_ms(nb, 12 * x.numel())
                ms = time_ms(torch, lambda: ec.affine_silu_bwd(x, gr, a, b), reps=10)
                per_shape.append(dict(c=c, spatial=list(sp), sites_per_forward=n, ms=ms,
                                      bound_ms=b_ms, bound_by=b_by))
                step_ms += n * ms
                step_bound += n * b_ms
            del x, gr, got, again, ref
    bad = [c for c in checks if not (c["tol_ratio"] <= 1.0 and c["bit_identical_twice"])]
    if bad:
        fail(f"the K3 VJP kernel disagrees with its plain version or itself: {bad}")
    # level 0, 64 channels: the record of the kernels line
    c, sp = 64, (112, 112, 80)
    x = torch.randn((1, *sp, c), generator=g, device="cuda").to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    gr = torch.randn((1, *sp, c), generator=g, device="cuda").to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    a = torch.randn((1, c), generator=g, device="cuda")
    b = torch.randn((1, c), generator=g, device="cuda")
    nb = 3 * x.numel() * 2 + 4 * a.numel() * 4
    b_ms, b_by = bound_ms(nb, 12 * x.numel())
    torch.cuda.empty_cache()
    return dict(
        shape=list(x.shape), dtype="bfloat16", format="channels_last_3d",
        max_abs_err=worst_err, tol_ratio=worst_ratio, tol=VJP_TOL,
        ms=time_ms(torch, lambda: ec.affine_silu_bwd(x, gr, a, b)),
        plain_ms=time_ms(torch, lambda: ec.affine_silu_bwd_plain(x, gr, a, b), reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nb,
        per_step_ms=step_ms, per_step_bound_ms=step_bound, per_shape=per_shape,
        checks=checks,
    )


# run.sh's COMMON flags, with the 10-step sampled schedule
COMMON_FLAGS = dict(
    dims=3, num_groups=32, num_channels=64, num_res_blocks=2, channel_mult="1,2,2,4,4",
    attention_resolutions="", bottleneck_attention=False, image_size=112, in_channels=32,
    out_channels=8, resample_2d=False, use_scale_shift_norm=False, additive_skips=False,
    diffusion_steps=10, sample_schedule="sampled", noise_schedule="linear",
    predict_xstart=True, mode="i2i", dataset="brats", dtype="bfloat16",
)


def train_flags(data_dir: str, ckpt_dir: str, steps: int, **extra) -> list:
    """``run.sh``'s COMMON and TRAIN flags for ``cli.train`` (contr t1c),
    cut to ``steps`` optimizer steps with a BEST save at the last, a log
    line every step, the 10-step sampled schedule and the cached dataset."""
    flags = dict(
        COMMON_FLAGS,
        # TRAIN
        data_dir=data_dir, lr=1e-5, batch_size=1, log_interval=1, save_interval=steps,
        lr_anneal_steps=steps, use_checkpoint=True, num_workers=12, checkpoint_dir=ckpt_dir,
        contr="t1c", cache_dataset=True, seed=0,
    )
    flags.update(extra)
    return [f"--{k}={v}" for k, v in flags.items()]


def run_train(torch, tmp: str, name: str, argv: list, steps: int, on_done=None) -> dict:
    """One ``cli.train`` run on the card: its launches per step, warm
    s/step, peak memory, losses, and how far the parameters moved from the
    run's own init (the same seed builds the same init). ``on_done`` is
    called with the finished loop, after the counts are read."""
    import contextlib

    from fast_cwdm_tpu_torch.cli import train
    from fast_cwdm_tpu_torch.models.factory import create_model_and_diffusion

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with open(os.path.join(tmp, f"{name}.stdout"), "w") as out, contextlib.redirect_stdout(out):
        loop = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in loop.step_log]
    if loop.preempted or loop.state.step != steps or len(losses) != steps \
            or not all(math.isfinite(v) for v in losses):
        fail(f"{name}: cli.train did not run {steps} finite steps: {loop.step_log}")
    if on_done is not None:
        on_done(loop)
    torch.manual_seed(0)
    init, _ = create_model_and_diffusion(**loop.config)
    with torch.no_grad():
        moved = {k: float((p.float().cpu() - init.state_dict()[k]).abs().max())
                 for k, p in loop.state.params.items()}
    res = {
        "seconds": seconds, "steps": steps,
        "s_per_step_warm": statistics.median(r["seconds_per_step"] for r in loop.step_log[1:])
        if steps > 1 else None,
        "s_per_step_all": [r["seconds_per_step"] for r in loop.step_log],
        "max_memory_allocated_bytes": peak, "losses": losses,
        "params_changed": sum(v > 0 for v in moved.values()), "params_total": len(moved),
        "params_unchanged": [k for k, v in moved.items() if v == 0],
        "max_abs_param_change": max(moved.values()),
        "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
        "n_params": sum(p.numel() for p in loop.state.params.values()),
    }
    del loop, init
    return res


def profile_train_step(torch, flags: dict) -> dict:
    """One production train step (batch 1, bf16, use_checkpoint) traced by
    ``profile_device`` after two warm steps, on seeded weights and a random
    batch."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from fast_cwdm_tpu_torch.training import state, train

    cfg, sd = seeded_production(torch, use_checkpoint=True, **flags)
    model, _ = common.build_model_and_diffusion(cfg)
    model.load_state_dict(sd)
    model.cuda()
    diffusion = GaussianDiffusion.named("linear", 10, "sampled", mode="i2i")
    opt = train.make_optimizer(1e-5, lr_anneal_steps=1000)
    step = train.make_train_step(model, diffusion, opt, contr="t1c")
    st = state.TrainState.create(model, opt, ema_rates=(0.9999,))
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {m: torch.rand((1, *VOLUME, 1), generator=g, device="cuda")
             for m in ("t1n", "t1c", "t2w", "t2f")}
    rng = train.StepRNG.seeded(0, "cuda")
    for _ in range(2):
        step(st, batch, rng)
    out = profile_device(torch, lambda: step(st, batch, rng))
    del model, st, opt
    torch.cuda.empty_cache()
    return out


def phase_training(torch, tmp: str, profile: bool = False) -> dict:
    """The K3 VJP kernel, then production training through ``cli.train``
    unfused and with fuse_gn_silu, and synthesis from the BEST it wrote;
    with ``profile`` a traced train step of each."""
    import shutil

    import numpy as np

    from fast_cwdm_tpu_torch.cli import complete_dataset
    from fast_cwdm_tpu_torch.training import checkpoints

    res = {"vjp_kernel": phase_vjp_kernel(torch)}
    data = os.path.join(tmp, "data")
    for k in range(2):
        write_case(os.path.join(data, f"0000{k + 1}"), seed=10 + k)
    os.environ["OPENAI_LOGDIR"] = os.path.join(tmp, "log")
    os.environ["OPENAI_LOG_FORMAT"] = "log,csv"
    n = TRAIN_STEPS
    runs = {"unfused": (os.path.join(tmp, "ckpt_a"), {}),
            "fuse_gn_silu": (os.path.join(tmp, "ckpt_b"), {"fuse_gn_silu": True})}
    for name, (ckpt_dir, extra) in runs.items():
        r = run_train(torch, tmp, name, train_flags(data, ckpt_dir, n, **extra), n)
        k3 = (71 + REMAT_GN_SITES) * n if extra else 0
        want = {"haar_dwt3": 5 * n, "haar_idwt3": n, "affine_silu": k3,
                "affine_silu_bwd": 71 * n if extra else 0, "conv3d_fused_k4b": 0,
                "conv3d_fused_k4a": 0, "conv3d_fused_v4": 0, "gn_stats": 0}
        r["launches_expected"] = want
        bad = {k: (r["launches"][k], v) for k, v in want.items() if r["launches"][k] != v}
        # a tensor whose gradient is exactly 0 for these few steps (a GN
        # scale over constant groups) does not move; most must
        if bad or r["n_params"] != 81_511_048 or r["params_changed"] < 0.9 * r["params_total"]:
            fail(f"training run {name}: launches (got, expected) {bad}, {r}")
        found = checkpoints.find_best_checkpoint(ckpt_dir, "t1c")
        cfg = checkpoints.load_checkpoint_config(found[0]) if found else {}
        if not found or cfg.get("step") != n or bool(cfg.get("fuse_gn_silu")) != bool(extra):
            fail(f"training run {name} wrote no BEST at step {n}: {found} {cfg}")
        r["best"] = os.path.basename(found[0])
        res[name] = r
    # (a) without use_checkpoint: its peak memory, two steps
    try:
        r = run_train(torch, tmp, "unfused_no_remat",
                      train_flags(data, os.path.join(tmp, "ckpt_c"), 2, use_checkpoint=False), 2)
        res["unfused_no_remat"] = {k: r[k] for k in ("max_memory_allocated_bytes",
                                                     "s_per_step_warm", "losses")}
    except torch.cuda.OutOfMemoryError as e:
        res["unfused_no_remat"] = {"did_not_fit": str(e).splitlines()[0]}
    torch.cuda.empty_cache()
    res["fuse_conv_backward_raises"] = fuse_conv_backward_raises(torch)
    if profile:
        res["profile"] = {name: profile_train_step(torch, flags)
                          for name, flags in (("unfused", {}), ("fuse_gn_silu", {"fuse_gn_silu": True}))}

    # train → checkpoint → synthesis: (a)'s BEST through complete_dataset
    in_dir = os.path.join(tmp, "complete_in")
    shutil.copytree(os.path.join(data, "00001"), os.path.join(in_dir, "00001"))
    os.remove(os.path.join(in_dir, "00001", "BraTS-GLI-00001-000-t1c.nii.gz"))
    out_dir = os.path.join(tmp, "complete_out")
    reset_counts()
    got = complete_dataset.main([f"--input_dir={in_dir}", f"--output_dir={out_dir}",
                                 f"--checkpoint_dir={runs['unfused'][0]}", "--seed=0"])
    torch.cuda.synchronize()
    counts = read_counts()
    if got["failed"] or list(got["seconds"]) != ["00001"] or counts["haar_dwt3"] != 3 \
            or counts["haar_idwt3"] != 1:
        fail(f"synthesis from the trained BEST: {got}, launches {counts}")
    res["synthesis_from_trained_best"] = {
        "s_per_case": got["seconds"], "launches": counts, "graph": check_graph_counts(volumes=1),
        "output": check_completed(np, in_dir, out_dir, "00001", "t1c")}
    return res


def fuse_conv_backward_raises(torch) -> str:
    """Fault 3.2 stays guarded: backward through a fuse_conv UNet on the
    card raises (the fused conv has no VJP, nor has the JAX package's)."""
    from fast_cwdm_tpu_torch.cli import common

    cfg = common.production_config(num_channels=16, num_res_blocks=1, channel_mult="1,2",
                                   num_groups=8, image_size=8, dtype="bfloat16", fuse_conv=True)
    model, _ = common.build_model_and_diffusion(cfg)
    model.cuda()
    x = torch.randn((1, 8, 8, 8, 32), device="cuda").permute(0, 4, 1, 2, 3)
    try:
        model(x, torch.tensor([1], device="cuda")).sum().backward()
    except RuntimeError as e:
        if "no backward" in str(e):
            return str(e).splitlines()[0]
        raise
    fail("backward through a fuse_conv UNet on the card did not raise")
    return ""


REFERENCE_RUNS = {  # name: (model flags, sampler, diffusion fields replaced)
    "fuse_gn_silu_ddpm": (dict(fuse_gn_silu=True), "ddpm", {}),
    "fuse_conv_ddpm": (dict(fuse_gn_silu=True, fuse_conv=True), "ddpm", {}),
    "fuse_conv_ddim": (dict(fuse_gn_silu=True, fuse_conv=True), "ddim", {}),
    "fuse_conv_dpm": (dict(fuse_gn_silu=True, fuse_conv=True), "dpm++", {}),
    # the reference's IDWT → clamp → DWT each step: K2 and K1 on the card
    "unfused_projection_ddpm": ({}, "ddpm", dict(fuse_clip_projection=False)),
}


def phase_reference(torch) -> dict:
    """The whole synthesis at a tiny fp32 config on the card, graphed and
    eager, against the same synthesis on the CPU, where the wrappers take
    their plain versions, which the CPU tests hold against the JAX package:
    every GN→SiLU through K3 under ddpm, then also every ResBlock conv
    through K4b under ddpm, ddim and dpm++; and the unfused model under
    ddpm with ``fuse_clip_projection=False`` (K1 13, K2 11 a volume). Same
    weights, same noise; TF32 off. Tolerance 1e-4 on the [0,1] image, as the CPU tests against JAX;
    the graph against the eager chain on the card: expected bit for bit."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    rng = np.random.default_rng(0)
    vols = {m: rng.random((1, 16, 16, 16, 1)).astype(np.float32)
            for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :4] = 0.0
    noise = rng.standard_normal((1, 8, 8, 8, 8)).astype(np.float32)
    step_noise = rng.standard_normal((10, 1, 8, 8, 8, 8)).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for name, (flags, sampler, changes) in REFERENCE_RUNS.items():
        cfg = common.production_config(
            num_channels=16, num_res_blocks=1, channel_mult="1,2", num_groups=8,
            image_size=8, diffusion_steps=10, sample_schedule="sampled",
            dtype="float32", **flags,
        )
        out, k4b, haar = {}, {}, {}
        for path, dev, graphed in (("cpu", "cpu", False), ("eager", "cuda", False),
                                   ("graph", "cuda", True)):
            model, diffusion = common.build_model_and_diffusion(cfg)
            shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in seeded_state_dict(shapes).items()})
            run = common.make_synthesis_fn(model, diffusion.replace(**changes), crop_z=12,
                                           sampler=sampler, device=dev, cuda_graph=graphed)
            reset_counts()
            cond = common.prepare_condition(vols, "t1c", device=dev)
            out[path] = run(cond, vols["t1n"], noise=noise, step_noise=step_noise)
            got = read_counts()
            k4b[path] = got["conv3d_fused_k4b"]
            haar[path] = {k: got[k] for k in ("haar_dwt3", "haar_idwt3")}
        res[name] = {"shape": list(out["graph"].shape), "tol": 1e-4,
                     "max_image": float(out["cpu"].max()), "k4b_launches": k4b,
                     "haar_launches": haar}
        for path in ("eager", "graph"):
            res[name][f"max_abs_err_{path}_vs_cpu"] = float(np.abs(out[path] - out["cpu"]).max())
        res[name]["max_abs_diff_graph_vs_eager"] = float(np.abs(out["graph"] - out["eager"]).max())
        if not (max(res[name]["max_abs_err_eager_vs_cpu"], res[name]["max_abs_err_graph_vs_cpu"],
                    res[name]["max_abs_diff_graph_vs_eager"]) <= 1e-4
                and np.isfinite(out["graph"]).all() and np.isfinite(out["eager"]).all()):
            fail(f"the synthesis on the card disagrees with the CPU's: {name} {res[name]}")
        if flags.get("fuse_conv") and (k4b["eager"], k4b["graph"]) != (160, 160):
            fail(f"the tiny fuse_conv synthesis launched K4b {k4b}, expected 160 on the card")
        steps = 10 if changes.get("fuse_clip_projection") is False else 0
        want = {"haar_dwt3": 3 + steps, "haar_idwt3": 1 + steps}
        if (haar["eager"], haar["graph"]) != (want, want):
            fail(f"the tiny synthesis launched K1/K2 {haar}, expected {want} on the card")
    torch.backends.cudnn.allow_tf32 = True
    return res


# the model-free anchors of the JAX package's quality records: the copy rows
# of QUALITY_r04.json and the real leg of QUALITY_downstream_r04.json (the
# same in every r04/r05 downstream record), and the GT region means of the
# r05 records
QUALITY_RECORD = "QUALITY_r04.json"
DOWNSTREAM_RECORD = "QUALITY_downstream_r04.json"
REGION_RECORD = "QUALITY_downstream_sampled10_r05.json"
EVAL_TRAIN_STEPS = 4  # run.sh --mode train, cut from 5,000


def start_run_sh(tmp: str, name: str, *args: str) -> tuple:
    """Start ``fast_cwdm_tpu_torch/run.sh`` with ``args`` in a child process
    (its ``python`` this interpreter), each CLI process it runs appending
    its launch counts to a file of run ``name``'s own at exit."""
    bin_dir = os.path.join(tmp, "bin")
    python = os.path.join(bin_dir, "python")
    if not os.path.exists(python):
        os.makedirs(bin_dir, exist_ok=True)
        with open(python, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(python, 0o755)
    counts_file = os.path.join(tmp, f"counts_{name}.jsonl")
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ.get('PATH', '')}",
               FAST_CWDM_LAUNCH_COUNTS=counts_file,
               OPENAI_LOGDIR=os.path.join(tmp, "log", name), OPENAI_LOG_FORMAT="log,csv")
    cmd = ["bash", os.path.join(REPO, "fast_cwdm_tpu_torch", "run.sh"), *args]
    out, err = (open(os.path.join(tmp, f"run_{name}.{x}"), "w+") for x in ("out", "err"))
    return args, subprocess.Popen(cmd, env=env, stdout=out, stderr=err), counts_file, out, err


def finish_run_sh(run: tuple) -> tuple[list, str]:
    """Wait for a run of :func:`start_run_sh`; the launch counts of each CLI
    process it ran, and its stdout. Fails on a nonzero exit."""
    args, proc, counts_file, out, err = run
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if rc != 0:
        fail(f"run.sh {' '.join(args)} exited {rc}: {stdout[-2000:]} {stderr[-3000:]}")
    with open(counts_file) as f:
        return [json.loads(line) for line in f], stdout


def expect_counts(name: str, got: dict, want: dict) -> None:
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        fail(f"{name}: launches (got, expected) {bad}; all counts {got}")


def phase_evaluation(torch, tmp: str) -> dict:
    """The BraSyn evaluation chain at full size (240×240×155 phantoms, the
    production config of run.sh's COMMON bundle, bf16), through the port's
    entry points: ``scripts.quality_bench`` stage gen (2 train and 4 val
    phantoms, val seeds 10000-10003); ``run.sh --mode train`` (t1c, sampled
    10, 4 steps: K1 5 and K2 1 per step) into the bench's
    ``ckpt_sampled_10``; ``quality_bench`` stage eval (copy rows equal to
    QUALITY_r04.json's within 1e-9; legs sampled-10 and +ema, a 4-step
    pipeline check whose quality means nothing); ``cli.drop_modality``
    (seed 123456); then at once, in three children and this process:
    ``run.sh --mode complete`` from the trained weights (under the name of
    every modality the draw dropped), as written (3 K1 + 1 K2 per case) and
    with ``fuse_conv`` in the sidecars and dpm++ 10 (540 K4b per case: 300
    wgmma, 240 split-K), ``run.sh --mode sample``, and
    ``scripts.downstream_bench`` (real leg and GT region means equal to the
    JAX records within 1e-12); then ``cli.prepare_nnunet_dataset``,
    ``cli.evaluate_synthesis --mode direct`` on the card on the sampled
    tree, and ``ssim3d``/``psnr`` on the card against the same functions on
    the CPU for one full-size pair."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import drop_modality, prepare_nnunet_dataset
    from fast_cwdm_tpu_torch.cli import evaluate_synthesis as ev
    from fast_cwdm_tpu_torch.data import nifti
    from fast_cwdm_tpu_torch.scripts import downstream_bench, quality_bench
    from fast_cwdm_tpu_torch.training import checkpoints

    with open(os.path.join(REPO, QUALITY_RECORD)) as f:
        copy_ref = {r["leg"]: r for r in json.load(f)["rows"] if r["model"] == "-"}
    with open(os.path.join(REPO, DOWNSTREAM_RECORD)) as f:
        real_ref = json.load(f)["legs"]["real"]
    with open(os.path.join(REPO, REGION_RECORD)) as f:
        region_ref = json.load(f)["gt_region_means"]
    res, seconds = {}, {}
    work = os.path.join(tmp, "qb")
    qb_flags = [f"--workdir={work}", "--train_cases=2", "--val_cases=4",
                "--schedules=sampled:10"]
    t0 = time.perf_counter()

    # 1. phantoms
    quality_bench.main(qb_flags + ["--stages=gen"])
    train_dir, val_dir = os.path.join(work, "train"), os.path.join(work, "val")
    cases = sorted(d for d in os.listdir(val_dir) if os.path.isdir(os.path.join(val_dir, d)))
    if cases != ["10000", "10001", "10002", "10003"] or len(os.listdir(train_dir)) != 3:
        fail(f"stage gen wrote {cases} and {sorted(os.listdir(train_dir))}")
    seconds["gen"] = time.perf_counter() - t0

    # 2. training through run.sh, into the bench's checkpoint directory
    t1 = time.perf_counter()
    ckpt_dir = quality_bench.ckpt_dir_for(quality_bench.parse_args(qb_flags), "sampled", 10)
    n = EVAL_TRAIN_STEPS
    procs, out = finish_run_sh(start_run_sh(
        tmp, "train", "--mode", "train", "--train_modality", "t1c",
        "--sampling-strategy", "sampled", "--timesteps", "10", "--data_dir", train_dir,
        "--checkpoint_dir", ckpt_dir, "--extra",
        f"--lr_anneal_steps={n} --log_interval=1 --save_interval={n}"))
    if len(procs) != 1 or "[TIMING] Training for t1c completed" not in out:
        fail(f"run.sh --mode train: {procs} {out[-2000:]}")
    expect_counts("run.sh --mode train", procs[0]["launches"],
                  dict(IDLE, haar_dwt3=5 * n, haar_idwt3=n))
    found = checkpoints.find_best_checkpoint(ckpt_dir, "t1c")
    cfg = checkpoints.load_checkpoint_config(found[0]) if found else {}
    if not found or cfg.get("step") != n or found[1:] != ("sampled", 10):
        fail(f"run.sh --mode train wrote no BEST at step {n}: {found} {cfg}")
    best = found[0]
    res["train"] = {"best": os.path.basename(best), "bytes": os.path.getsize(best),
                    "launches_per_step": {k: v / n for k, v in procs[0]["launches"].items()}}
    seconds["train"] = time.perf_counter() - t1

    # 3. quality_bench stage eval on the card
    t1 = time.perf_counter()
    reset_counts()
    rows = quality_bench.main(qb_flags + ["--stages=eval"])
    torch.cuda.synchronize()
    got = read_counts()
    expect_counts("quality_bench stage eval", got,
                  dict(IDLE, haar_dwt3=2 * 3 * len(cases), haar_idwt3=2 * len(cases)))
    by_leg = {r["leg"]: r for r in rows}
    if list(by_leg) != ["copy-t1n", "copy-t2w", "copy-t2f", "sampled-10", "sampled-10+ema"]:
        fail(f"stage eval rows: {list(by_leg)}")
    res["copy_rows_vs_record"] = {
        leg: {k: by_leg[leg][k] - copy_ref[leg][k] for k in ("ssim_mean", "ssim_min", "psnr_mean")}
        for leg in ("copy-t1n", "copy-t2w", "copy-t2f")}
    worst = max(abs(d) for v in res["copy_rows_vs_record"].values() for d in v.values())
    res["copy_rows_max_abs_diff_vs_record"] = worst
    if not worst <= 1e-9:
        fail(f"the copy rows differ from {QUALITY_RECORD}: {res['copy_rows_vs_record']}")
    for leg in ("sampled-10", "sampled-10+ema"):
        r = by_leg[leg]
        if not (all(-1.0 <= r[k] <= 1.0 for k in ("ssim_mean", "ssim_min"))
                and math.isfinite(r["psnr_mean"]) and r["s_per_volume"] > 0):
            fail(f"model row {leg}: {r}")
    res["quality_rows"] = rows
    res["quality_launches"] = got
    seconds["quality_eval"] = time.perf_counter() - t1

    # 4. drop_modality; then three run.sh children at once: completion from
    # the trained weights under the name of every modality (the draw drops
    # t1c, t1n and t2f), as written (a) and with fuse_conv in the sidecars
    # and dpm++ 10 (b), and run.sh --mode sample; meanwhile downstream_bench
    # in this process (its launches are this process's counts, each child's
    # its own). Nothing of theirs is timed: only the host start-up overlaps.
    t1 = time.perf_counter()
    drop_dir = os.path.join(tmp, "dropped")
    drop_modality.main([f"--input_dir={val_dir}", f"--output_dir={drop_dir}"])
    missing = {}
    for case in cases:
        marks = [f for f in os.listdir(os.path.join(drop_dir, case)) if f.startswith("missing_")]
        missing[case] = marks[0][len("missing_"):-len(".txt")]
    res["dropped"] = missing
    with open(best + ".json") as f:
        sidecar = json.load(f)
    runs = {"complete_a": ([], {}, dict(IDLE, haar_dwt3=3 * len(cases), haar_idwt3=len(cases))),
            "complete_b": (["--extra", "--sampler=dpm++ --sampling_steps=10"], {"fuse_conv": True},
                           dict(IDLE, haar_dwt3=3 * len(cases), haar_idwt3=len(cases),
                                conv3d_fused_k4b=540 * len(cases), conv3d_wgmma=300 * len(cases),
                                conv3d_splitk=240 * len(cases)))}
    samp = os.path.join(tmp, "sampled")
    torch.cuda.empty_cache()  # the children share the card with this process
    started = {}
    try:
        for name, (extra, side, _) in runs.items():
            cdir = os.path.join(tmp, f"ckpt_{name}")
            os.makedirs(cdir)
            for m in ("t1n", "t1c", "t2w", "t2f"):
                dst = os.path.join(cdir, checkpoints.best_checkpoint_name(m, "sampled", 10))
                os.link(best, dst)
                with open(dst + ".json", "w") as f:
                    json.dump(dict(sidecar, contr=m, **side), f, indent=2)
            started[name] = start_run_sh(tmp, name, "--mode", "complete", "--val_dir", drop_dir,
                                         "--output_dir", os.path.join(tmp, name),
                                         "--checkpoint_dir", cdir, *extra)
        started["sample"] = start_run_sh(
            tmp, "sample", "--mode", "sample", "--train_modality", "t1c",
            "--sampling-strategy", "sampled", "--timesteps", "10",
            "--val_dir", val_dir, "--output_dir", samp, "--checkpoint_dir", ckpt_dir)

        # 5. downstream_bench on the same val tree and checkpoint
        reset_counts()
        down = downstream_bench.main([f"--workdir={os.path.join(tmp, 'downstream')}",
                                      f"--val_dir={val_dir}", f"--checkpoint_dir={ckpt_dir}",
                                      "--sampler=dpm++", "--sampling_steps=10"])
        torch.cuda.synchronize()
        got = read_counts()
        finished = {name: finish_run_sh(run) for name, run in started.items()}
    finally:
        for run in started.values():  # a failure stops every child
            if run[1].poll() is None:
                run[1].kill()
                run[1].wait()
    expect_counts("downstream_bench", got,
                  dict(IDLE, haar_dwt3=3 * len(cases), haar_idwt3=len(cases)))
    real = down["legs"]["real"]
    res["downstream"] = {
        "device": down["device"], "real": {k: real[k] for k in ("n", "dice_mean", "dice_mean_ref")},
        "real_vs_record": {k: real[k] - real_ref[k] for k in ("dice_mean", "dice_mean_ref")},
        "gt_region_means": down["gt_region_means"],
        "gt_region_means_vs_record": {k: down["gt_region_means"][k] - v
                                      for k, v in region_ref.items()},
        "synth": {k: down["legs"]["synth_dpm++-10"][k] for k in ("n", "dice_mean")},
        "agreement": down["agreement"]}
    diffs = list(res["downstream"]["real_vs_record"].values()) + list(
        res["downstream"]["gt_region_means_vs_record"].values())
    if real["n"] != real_ref["n"] or not max(abs(d) for d in diffs) <= 1e-12:
        fail(f"the downstream real leg or GT region means differ from the records: "
             f"{res['downstream']}")
    models = len(set(missing.values()))
    for name, (_, _, want) in runs.items():
        procs, out = finished[name]
        if len(procs) != 1 or f"done: {len(cases)} ok, 0 failed" not in out:
            fail(f"run.sh --mode complete ({name}): {out[-2000:]}")
        expect_counts(f"run.sh --mode complete ({name})", procs[0]["launches"], want)
        graph = {"captures": models, "replays": 10 * len(cases) - 2 * models}
        if procs[0]["graph"] != graph:
            fail(f"{name}: graph counts {procs[0]['graph']}, expected {graph}")
        res[name] = {"launches_per_case": {k: v / len(cases) for k, v in procs[0]["launches"].items()},
                     "graph": procs[0]["graph"],
                     "outputs": {c: check_completed(np, drop_dir, os.path.join(tmp, name), c, m)
                                 for c, m in missing.items()}}
    procs, _ = finished["sample"]
    expect_counts("run.sh --mode sample", procs[0]["launches"],
                  dict(IDLE, haar_dwt3=3 * len(cases), haar_idwt3=len(cases)))
    seconds["drop_complete_sample_downstream"] = time.perf_counter() - t1

    # 6. nnU-Net layout of the completed tree
    t1 = time.perf_counter()
    raw = os.path.join(tmp, "nnunet_raw")
    prepare_nnunet_dataset.main([f"--input_dir={os.path.join(tmp, 'complete_a')}",
                                 f"--nnunet_raw={raw}"])
    ds = os.path.join(raw, "Dataset137_BraTS2023")
    with open(os.path.join(ds, "dataset.json")) as f:
        n_train = json.load(f)["numTraining"]
    images, labels = sorted(os.listdir(os.path.join(ds, "imagesTr"))), os.listdir(
        os.path.join(ds, "labelsTr"))
    if n_train != len(cases) or len(images) != 4 * len(cases) or len(labels) != len(cases):
        fail(f"prepare_nnunet_dataset: {n_train} cases, {len(images)} images, {len(labels)} labels")
    res["nnunet"] = {"numTraining": n_train, "images": len(images), "labels": len(labels)}
    seconds["nnunet"] = time.perf_counter() - t1

    # 7. evaluate_synthesis --mode direct on the card, on run.sh --mode
    # sample's output, alone on the machine (its s/case is reported)
    t1 = time.perf_counter()
    report = ev.main(["--mode=direct", f"--sample_dir={samp}",
                      f"--report={os.path.join(tmp, 'evaluation_report.json')}"])
    eval_s = time.perf_counter() - t1
    if report["n"] != len(cases) or not all(
            -1.0 <= r["ssim"] <= 1.0 and math.isfinite(r["psnr"]) for r in report["cases"]):
        fail(f"evaluate_synthesis: {report}")
    res["sample_evaluate"] = {"report": {k: v for k, v in report.items() if k != "cases"},
                              "evaluate_s_per_case": eval_s / len(cases)}
    seconds["evaluate"] = eval_s

    # 8. ssim3d / psnr on the card against the CPU, one full-size pair
    t1 = time.perf_counter()
    s = nifti.load(os.path.join(samp, cases[0], "sample.nii.gz")).get_fdata()
    g = nifti.load(os.path.join(samp, cases[0], "target.nii.gz")).get_fdata()
    on = {dev: (torch.from_numpy(s).to(dev), torch.from_numpy(g).to(dev)) for dev in ("cpu", "cuda")}
    vals, ms = {}, {}
    for dev, (a, b) in on.items():
        times = []
        for _ in range(3 if dev == "cuda" else 1):
            if dev == "cuda":
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            vals[dev] = (ev.ssim3d(a, b), ev.psnr(a, b))  # float() synchronises
            times.append((time.perf_counter() - t2) * 1e3)
        ms[dev] = min(times)
    res["metric_card_vs_cpu"] = {
        "shape": list(s.shape), "ssim": vals, "ms_ssim_psnr": ms,
        "ssim_abs_diff": abs(vals["cuda"][0] - vals["cpu"][0]),
        "psnr_abs_diff": abs(vals["cuda"][1] - vals["cpu"][1])}
    if not (res["metric_card_vs_cpu"]["ssim_abs_diff"] <= 1e-10
            and res["metric_card_vs_cpu"]["psnr_abs_diff"] <= 1e-10):
        fail(f"ssim3d/psnr on the card differ from the CPU: {res['metric_card_vs_cpu']}")
    seconds["metric_card_vs_cpu"] = time.perf_counter() - t1
    res["seconds_by_step"] = seconds
    return res


# phase probes: on phase evaluation's trees and BEST (the 4-step
# production model, sampled 10), so the JAX record's t = 999..50 become
# the sampled-10 process's 9..0
PROBE_RECORD = "PROBE_core_inference_r05.json"
PROBE_KERNELS = ("haar_dwt3", "haar_idwt3", "affine_silu", "conv3d_fused_k4b")
PROBE_TIMESTEPS = ("9", "8", "6", "4", "2", "0")
REGRESSION_STEPS = 4  # probe_regression's training, cut from 5,000


def probe_launches(counts: dict) -> dict:
    """K1, K2, K3 and K4b of a launch-count dict (0 where absent)."""
    return {k: counts.get(k, 0) for k in PROBE_KERNELS}


def native_decoder(tmp: str, evaluation: dict) -> dict:
    """The native decoder built and used: every val modality decoded by
    ``load_preprocessed`` bit for bit equal to the numpy float32 path, ms
    per case of the decoder and that path, and of the float64 reader
    (``FAST_CWDM_NATIVE=0``) on the first volume; ``ThreadedLoader``'s
    cases/s over the six cases with the decoder and under
    ``FAST_CWDM_NATIVE=0``, one turn each, the decoder's count of
    volumes beside each; the decode's
    share of ``evaluate_cases`` (its two ``nifti.load`` per case against
    phase evaluation's s/case)."""
    from fast_cwdm_tpu_torch.data import brats, native, nifti
    from fast_cwdm_tpu_torch.data.loader import ThreadedLoader

    if not native.available():
        fail("the native decoder did not build (g++ -O3 -shared -fPIC fastnifti.cpp)")
    res = {}
    work = os.path.join(tmp, "qb")
    val = brats.BRATSVolumes(os.path.join(work, "val"))
    paths = [d[m] for d in val.database for m in brats.MODALITIES]
    ms = {"native": [], "numpy_float32": [], "numpy_float64": []}
    before = native.load_volume.decodes
    for i, p in enumerate(paths):
        t0 = time.perf_counter()
        a = brats.load_preprocessed(p)
        t1 = time.perf_counter()
        b = brats.pad_crop(brats.clip_and_normalize_float32(brats._load_float32(p)))
        t2 = time.perf_counter()
        if a.tobytes() != b.tobytes():
            fail(f"the native decoder and the numpy float32 path differ on {p}")
        ms["native"].append((t1 - t0) * 1e3)
        ms["numpy_float32"].append((t2 - t1) * 1e3)
        if i == 0:  # the float64 reader, timed on the first volume only
            brats.preprocess_volume(nifti.load(p).get_fdata())
            ms["numpy_float64"].append((time.perf_counter() - t2) * 1e3)
    res["volumes_bit_for_bit"] = len(paths)
    res["native_decodes"] = native.load_volume.decodes - before
    if res["native_decodes"] != len(paths):
        fail(f"load_preprocessed decoded {res['native_decodes']} of {len(paths)} volumes natively")
    res["ms_per_case"] = {k: 4 * statistics.median(v) for k, v in ms.items()}  # 4 volumes
    res["ms_per_volume_all"] = ms

    ds = brats.BRATSVolumes(os.path.join(work, "val"))
    ds.database += brats.BRATSVolumes(os.path.join(work, "train")).database
    workers = os.cpu_count() or 1
    loader = {"cases": len(ds), "workers": workers, "native": [], "numpy": [],
              "native_decodes": {"native": [], "numpy": []}}
    saved = os.environ.get("FAST_CWDM_NATIVE")
    try:
        for setting in ("native", "numpy"):
            os.environ["FAST_CWDM_NATIVE"] = "1" if setting == "native" else "0"
            before = native.load_volume.decodes
            t0 = time.perf_counter()
            n = sum(1 for _ in ThreadedLoader(ds, num_workers=workers))
            loader[setting].append(n / (time.perf_counter() - t0))
            loader["native_decodes"][setting].append(native.load_volume.decodes - before)
    finally:
        if saved is None:
            os.environ.pop("FAST_CWDM_NATIVE", None)
        else:
            os.environ["FAST_CWDM_NATIVE"] = saved
    if loader["native_decodes"] != {"native": [4 * len(ds)], "numpy": [0]}:
        fail(f"ThreadedLoader's decodes: {loader['native_decodes']}")
    res["loader_cases_per_s"] = loader

    samp = os.path.join(tmp, "sampled")
    decode, decode_native = [], []
    for case in sorted(os.listdir(samp)):
        pair = [os.path.join(samp, case, f) for f in ("sample.nii.gz", "target.nii.gz")]
        t0 = time.perf_counter()
        for p in pair:
            nifti.load(p).get_fdata()
        t1 = time.perf_counter()
        for p in pair:
            native.load_volume(p)
        decode.append(t1 - t0)
        decode_native.append(time.perf_counter() - t1)
    per_case = evaluation["sample_evaluate"]["evaluate_s_per_case"]
    res["evaluate_cases_decode"] = {
        "s_per_case_nifti_load": statistics.median(decode),
        "s_per_case_native": statistics.median(decode_native),
        "evaluate_s_per_case": per_case,
        "share": statistics.median(decode) / per_case}
    return res


class ProbeRuns:
    """Each probe's run through :meth:`run`: its seconds and its
    K1/K2/K3/K4b launches."""

    def __init__(self, torch):
        self.torch, self.seconds, self.launches = torch, {}, {}

    def run(self, name, fn):
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = probe_launches(read_counts())
        self.torch.cuda.empty_cache()
        return out


def probes_on_best(torch, tmp: str, evaluation: dict) -> dict:
    """Phase probes' two probes of phase evaluation's BEST, run in its
    child after it: ``probe_core_inference`` (its GT rows against the
    committed JAX record within 1e-6; K1 5, K2 7 a case) and
    ``probe_regression`` (4 training steps with the lesion term, the
    completion and the downstream chain in phase evaluation's
    ``downstream_bench`` workdir, whose real leg it reuses; its GT region
    means equal to that run's)."""
    from fast_cwdm_tpu_torch.scripts import probe_core_inference as pci
    from fast_cwdm_tpu_torch.scripts import probe_regression as pr
    from fast_cwdm_tpu_torch.scripts import quality_bench

    work = os.path.join(tmp, "qb")
    train_dir, val_dir = os.path.join(work, "train"), os.path.join(work, "val")
    ckpt_dir = quality_bench.ckpt_dir_for(quality_bench.parse_args([f"--workdir={work}"]),
                                          "sampled", 10)
    runs, res = ProbeRuns(torch), {}
    run, launches = runs.run, runs.launches
    # probe_core_inference on evaluation's BEST and val phantoms
    out = os.path.join(tmp, "probe_core_inference.json")
    core = run("core_inference", lambda: pci.main(
        ["--checkpoint_dir", ckpt_dir, "--val_dir", val_dir, "--out", out,
         "--timesteps", *PROBE_TIMESTEPS]))
    n_cases = len(core["gt"])
    want = dict.fromkeys(PROBE_KERNELS, 0)
    want.update(haar_dwt3=5 * n_cases, haar_idwt3=(len(PROBE_TIMESTEPS) + 1) * n_cases)
    if launches["core_inference"] != want:
        fail(f"probe_core_inference launches {launches['core_inference']}, expected {want}")
    if len(core["rows"]) != (len(PROBE_TIMESTEPS) + 1) * n_cases or not all(
            math.isfinite(r["healthy_mae"]) and all(
                r[k] is None or math.isfinite(r[k]) for k in ("et", "ncr", "edema"))
            for r in core["rows"]):
        fail(f"probe_core_inference rows: {core['rows']}")
    with open(os.path.join(REPO, PROBE_RECORD)) as f:
        record = {r["case"]: r for r in json.load(f)["gt"]}
    from fast_cwdm_tpu_torch.data import brats

    gt = {"vs_record": {}, "host_numpy_order_vs_record": {}}
    for row in core["gt"]:
        case_dir = os.path.join(val_dir, row["case"])
        x = brats.load_preprocessed(pci._find(case_dir, "t1c"))[..., 0]
        seg = brats.load_seg(pci._find(case_dir, "seg"))[..., 0]
        rec = record[row["case"]]
        gt["vs_record"][row["case"]] = {k: row[k] - rec[k] for k in ("et", "ncr", "edema")}
        # the same means in this host's numpy order (fault 6): reported only
        gt["host_numpy_order_vs_record"][row["case"]] = {
            name: float(x[seg == lbl].mean()) - rec[name] for lbl, name in pci.RAW_REGIONS.items()}
    worst = max(abs(d) for v in gt["vs_record"].values() for d in v.values())
    gt["max_abs_diff_vs_record"] = worst
    gt["host_numpy_order_max_abs_diff"] = max(
        abs(d) for v in gt["host_numpy_order_vs_record"].values() for d in v.values())
    gt["summation_order"] = "numpy 2.0's float32 pairwise order (data/reduce.py)"
    if sorted(record) != sorted(gt["vs_record"]) or not worst <= 1e-6:
        fail(f"probe_core_inference GT rows differ from {PROBE_RECORD}: {gt}")
    core["gt_check"] = gt
    res["core_inference"] = core

    # probe_regression: 4 steps with the lesion term (K1 5, K2 1 a step:
    # its IDWT and that IDWT's VJP on K1), the completion (K1 3, K2 1 a val
    # case) and the downstream chain, in phase evaluation's downstream_bench
    # workdir: its resumable stages reuse the real leg segmented there
    rep = run("regression", lambda: pr.main(
        ["--workdir", os.path.join(tmp, "downstream"), "--data_dir", train_dir,
         "--val_dir", val_dir, "--train_steps", str(REGRESSION_STEPS), "--log_interval", "1",
         "--save_interval", str(REGRESSION_STEPS), "--lesion_weight", "0.5",
         "--out", os.path.join(tmp, "probe_regression.json")]))
    want = dict.fromkeys(PROBE_KERNELS, 0)
    want.update(haar_dwt3=5 * REGRESSION_STEPS + 3 * n_cases,
                haar_idwt3=REGRESSION_STEPS + n_cases)
    if launches["regression"] != want:
        fail(f"probe_regression launches {launches['regression']}, expected {want}")
    down = evaluation["downstream"]
    real, reg = rep["legs"]["real"], rep["legs"]["regression"]
    means = list(reg["region_means"]["mean"].values()) + [rep["train"]["final"]["loss"]]
    if (real["dice_mean"] != down["real"]["dice_mean"]
            or rep["gt_region_means"] != down["gt_region_means"] or reg["n"] != n_cases
            or not all(v is not None and math.isfinite(v) for v in means)):
        fail(f"probe_regression report: {rep}")
    res["regression"] = {k: rep[k] for k in ("legs", "agreement", "gt_region_means", "train",
                                             "config")}
    return {**res, "launches": launches, "seconds_by_probe": runs.seconds}


def phase_probes(torch, tmp: str, evaluation: dict, on_best: dict) -> dict:
    """The JAX package's five probes, ported, at the production width on
    phase evaluation's trees (two train and four val 240×240×155 phantoms)
    and BEST, and the native decoder; each probe through its ``main`` as a
    user runs it, with the K1/K2/K3/K4b launches of its run:
    ``probe_elementwise`` (A: K3 against plain at the level-0 shape, B: the
    forward unfused and fused, C: the 100-step chain with K3 if B wins),
    ``probe_lane_ceiling`` (cuDNN at six channel pairs and K4b on its
    route at each, then every lane shape not in phase kernels held against
    the plain version; the fold's parity), ``probe_batch2`` (four legs, each
    must complete); ``on_best``: ``probe_core_inference`` and
    ``probe_regression``, run and checked in phase evaluation's child
    (:func:`probes_on_best`)."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc
    from fast_cwdm_tpu_torch.scripts import probe_batch2 as pb
    from fast_cwdm_tpu_torch.scripts import probe_elementwise as pe
    from fast_cwdm_tpu_torch.scripts import probe_lane_ceiling as pl

    runs, res = ProbeRuns(torch), {}
    run, seconds = runs.run, runs.seconds
    t0 = time.perf_counter()
    res["native"] = native_decoder(tmp, evaluation)
    seconds["native"] = time.perf_counter() - t0

    # probe_elementwise: A a K3 launch a call, B 71 a fused forward, C the
    # chain's; devtime(events=True) makes 7 calls (a warm-up, 3 on the host
    # clock, 3 behind a spin of the card)
    calls = 7
    el = run("elementwise", lambda: pe.main(["--walls", "1"]))
    k3_a = el["A"]["A/k3_affine_silu"]["launches"].get("affine_silu", 0)
    k3_b = el["B"]["launches"]["fuse_gn_silu=True"].get("affine_silu", 0)
    if (k3_a != calls or el["A"]["A/plain_affine_silu"]["launches"]
            or k3_b != 71 * calls
            or el["B"]["launches"]["fuse_gn_silu=False"].get("affine_silu", 0)):
        fail(f"probe_elementwise launches: {el['A']} {el['B']['launches']}")
    if el["B"]["delta_ms"] > 0 and not (el["C"] and el["C"]["finite"]
                                        and el["C"]["launches"].get("affine_silu", 0)):
        fail(f"probe_elementwise C: {el['C']}")
    res["elementwise"] = el

    # probe_lane_ceiling; then K4b at the lane shapes phase kernels does not
    # check, against the plain version (these launches are not counted)
    lane = run("lane_ceiling", lambda: pl.main([]))
    for ci, co in pl.PAIRS:
        k = lane[f"conv_{ci}->{co}"].get("k4b")
        if not k or k["route"] != "wgmma" or k["launches"].get("conv3d_fused_k4b") != calls:
            fail(f"probe_lane_ceiling K4b at {ci}->{co}: {k}")
    g = torch.Generator(device="cuda").manual_seed(14)
    checked = {(ci, sp, co) for _, b, ci, sp, co in CONV_SHAPES if b == 1}
    lane_checks = []
    with torch.inference_mode():
        for ci, co in pl.PAIRS:
            if (ci, LATENT, co) in checked:
                continue
            x, w, b, gn = conv_inputs(torch, g, 1, ci, LATENT, co, torch.bfloat16)
            y = tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=tc.pack_wgmma_weights(w))
            ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
            lane_checks.append({"ci": ci, "co": co, "tol_ratio": tc.tol_ratio(y, ref, x, w, gn),
                                "max_abs_err": float((y.float() - ref.float()).abs().max())})
            del x, w, b, gn, y, ref
    if not all(c["tol_ratio"] <= 1.0 for c in lane_checks):
        fail(f"K4b at the lane shapes disagrees with the plain version: {lane_checks}")
    lane["k4b_vs_plain"] = lane_checks
    res["lane_ceiling"] = lane

    # probe_batch2: every leg completes on 80 GB
    rows = run("batch2", lambda: pb.main(["--iters", "1"]))  # 3 steps a leg
    bad = [r for r in rows if "error" in r or not math.isfinite(r["loss"])
           or not (r["launches"].get("haar_dwt3") and r["launches"].get("haar_idwt3"))]
    if len(rows) != 4 or bad:
        fail(f"probe_batch2: {rows}")
    res["batch2"] = rows

    timed = ([v["ms"] for v in el["A"].values()] + list(el["B"]["forward_ms"].values())
             + [lane[k]["ms"] for k in lane if k.startswith("conv_")]
             + [lane[k]["k4b"]["ms"] for k in lane if k.startswith("conv_")]
             + [lane[k] for k in ("fold_plain_ms", "fold_full_ms", "fold_steady_ms")]
             + [r["ms_per_step"] for r in rows])
    if not all(ms > 0 for ms in timed):
        fail(f"a probe leg measured no device time: {timed}")
    res["core_inference"], res["regression"] = on_best["core_inference"], on_best["regression"]
    res["launches"] = {**runs.launches, **on_best["launches"]}
    res["seconds_by_probe"] = {**seconds, **on_best["seconds_by_probe"]}
    return res


# phase models: the WavUNet at run.sh's COMMON widths with four levels
# (five would halve the 112×112×80 latent to an odd size and raise, as in
# the JAX package), and the production UNet with attention at ds 8 and 16
# (1,960 and 245 positions) and in the bottleneck
MODELS_TRAIN_STEPS = 3
WUNET_FLAGS = dict(use_freq=True, channel_mult="1,2,2,4")
WUNET_PARAMS = 54_285_640  # the JAX package's WavUNetModel at these flags (jax.eval_shape)
ATTENTION_FLAGS = dict(bottleneck_attention=True, attention_resolutions="14,7", num_heads=4)


def eager_vs_graph(torch, np, model, diffusion, batch, sampler: str) -> dict:
    """``make_synthesis_fn`` eager and graphed on one case and one seed: a
    first call each (the graph's capture), then one timed call each
    (g, e); the images of the two paths, expected bit for bit,
    and s/volume (host clock, condition DWTs to the image on the host)."""
    from fast_cwdm_tpu_torch.cli import common

    runs = {p: common.make_synthesis_fn(model, diffusion, sampler=sampler, sampler_steps=10,
                                        device="cuda", cuda_graph=p == "graph")
            for p in ("eager", "graph")}
    imgs, times = {}, {p: [] for p in runs}
    for k, p in enumerate(("eager", "graph", "graph", "eager")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        img = runs[p](common.prepare_condition(batch, "t1c", device="cuda"), batch["t1n"], gen)
        seconds = time.perf_counter() - t0
        if k < 2:
            imgs[p] = img
        else:
            times[p].append(seconds)
            if not np.array_equal(img, imgs[p]):
                fail(f"{sampler}: a second {p} call on the same seed gave another image")
    res = {f"s_per_volume_{p}": statistics.median(v) for p, v in times.items()}
    res.update({f"s_per_volume_{p}_all": v for p, v in times.items()})
    res["max_abs_diff_graph_vs_eager"] = float(np.abs(imgs["graph"] - imgs["eager"]).max())
    res["capture_s"] = runs["graph"].chain.graph.capture_seconds
    res["max_image"] = float(imgs["eager"].max())
    if not np.array_equal(imgs["graph"], imgs["eager"]) or not np.isfinite(imgs["eager"]).all():
        fail(f"{sampler}: the graphed synthesis differs from the eager one: {res}")
    return res


def wunet_wavelet_ms(torch, model) -> dict:
    """The WavUNet's multi-channel Haar transforms (plain torch, as XLA in
    the JAX package) in one bf16 forward at the production latent: the
    shape of every ``wav_down``/``wav_up`` call is recorded, each call is
    timed alone with CUDA events at its shape (``time_ms``) and the times
    are summed per forward, beside the forward's device time (``devtime``,
    one traced call)."""
    from fast_cwdm_tpu_torch.models import wunet
    from fast_cwdm_tpu_torch.utils.devtime import devtime

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, *LATENT, 32), generator=g, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([5], device="cuda")
    calls = []
    originals = {"wav_down": wunet.wav_down, "wav_up": wunet.wav_up}

    def recorder(name):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return call

    with torch.inference_mode():
        try:
            wunet.wav_down, wunet.wav_up = recorder("wav_down"), recorder("wav_up")
            model(x, t)
        finally:
            wunet.wav_down, wunet.wav_up = originals["wav_down"], originals["wav_up"]
        per_call = []
        for name, args, kw in calls:
            ms = time_ms(torch, lambda: originals[name](*args, **kw), reps=10)
            per_call.append({"fn": name, "shape": list(args[0].shape),
                             "dtype": str(args[0].dtype), "ms": ms})
        forward = devtime(lambda: model(x, t), iters=1)
    del calls
    res = {f"{n}_ms_per_forward": sum(c["ms"] for c in per_call if c["fn"] == n)
           for n in originals}
    res.update(calls_per_forward={n: sum(c["fn"] == n for c in per_call) for n in originals},
               per_call=per_call, forward_device_ms=forward["total_ms"],
               forward_wall_ms=forward["wall_ms"], forward_busy_share=forward["busy_share"])
    res["share_of_forward_device_ms"] = (
        (res["wav_down_ms_per_forward"] + res["wav_up_ms_per_forward"]) / forward["total_ms"])
    return res


def seeded(torch, model) -> dict:
    """Seeded weights keyed by the torch names, loaded into ``model``; its
    state_dict afterwards (a tensor shared under two keys keeps the value
    of its last one)."""
    from fast_cwdm_tpu_torch.utils.testing import seeded_state_dict

    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes).items()})
    return {k: v.clone() for k, v in model.state_dict().items()}


def phase_models(torch, tmp: str) -> dict:
    """The rest of the network surface on the card. (a) ``cli.train`` with
    run.sh's COMMON and TRAIN flags and ``--use_freq=True
    --channel_mult=1,2,2,4`` (the WavUNet) on two 240×240×155 cases for a
    few steps and a BEST (K1 5 and K2 1 per step), then ``cli.sample``
    from that BEST with run.sh's COMMON flags (its sidecar brings
    ``use_freq`` and the widths back; 3 K1 + 1 K2, the captured chain), its
    ``make_synthesis_fn`` eager against graphed (bit for bit) and the
    device ms of its multi-channel Haar transforms in a forward. (b) The
    production UNet with attention (ds 8 and 16 and the bottleneck, 4
    heads), seeded weights written as a JAX-layout ``.ckpt`` and read back
    bit for bit, ``cli.sample`` unfused ddpm and with ``fuse_conv`` dpm++ 10
    (540 K4b: 300 wgmma, 240 split-K), eager against graphed for both, and
    its ms/forward beside the production forward's, in turns. (c) Every new
    module at a tiny fp32 size on the card against the CPU (models_reference)."""
    import shutil

    import numpy as np

    from fast_cwdm_tpu_torch.cli import common, sample
    from fast_cwdm_tpu_torch.data import brats
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.models.factory import model_and_diffusion_defaults
    from fast_cwdm_tpu_torch.training import checkpoints

    res = {}
    data = os.path.join(tmp, "data")
    for k in range(2):
        write_case(os.path.join(data, f"0000{k + 1}"), seed=20 + k)
    serve = os.path.join(tmp, "serve")  # one case to sample
    shutil.copytree(os.path.join(data, "00001"), os.path.join(serve, "00001"))
    item = brats.BRATSVolumes(serve)[0]
    batch = {m: item[m][None] for m in brats.MODALITIES}
    mask = batch["t1n"][0, ..., 0][:, :, :155]
    os.environ["OPENAI_LOGDIR"] = os.path.join(tmp, "log")
    os.environ["OPENAI_LOG_FORMAT"] = "log,csv"

    def run_sample(name, argv, want):
        out_dir = os.path.join(tmp, name)
        reset_counts()
        seconds = sample.main(argv + [f"--data_dir={serve}", "--contr=t1c", "--seed=0",
                                      f"--output_dir={out_dir}"])
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(name, counts, want)
        return {"s_per_volume_cli": seconds[0], "launches": counts,
                "graph": check_graph_counts(volumes=1),
                "sample_shape": check_sample(np, os.path.join(out_dir, "00001", "sample.nii.gz"),
                                             mask)}

    # (a) the WavUNet: train, then serve from its BEST
    n = MODELS_TRAIN_STEPS
    ckpt_dir = os.path.join(tmp, "ckpt_wunet")
    r = run_train(torch, tmp, "wunet", train_flags(data, ckpt_dir, n, **WUNET_FLAGS), n)
    r["launches_expected"] = dict(IDLE, haar_dwt3=5 * n, haar_idwt3=n)
    expect_counts("WavUNet training", r["launches"], r["launches_expected"])
    if r["n_params"] != WUNET_PARAMS or r["params_changed"] < 0.9 * r["params_total"]:
        fail(f"WavUNet training: {r}")
    found = checkpoints.find_best_checkpoint(ckpt_dir, "t1c")
    stored = checkpoints.load_checkpoint_config(found[0]) if found else {}
    if not found or stored.get("step") != n or stored.get("use_freq") is not True \
            or stored.get("channel_mult") != WUNET_FLAGS["channel_mult"]:
        fail(f"WavUNet training wrote no BEST with use_freq at step {n}: {found} {stored}")
    r["best"] = os.path.basename(found[0])
    res["wunet_train"] = r
    common_flags = [f"--{k}={v}" for k, v in COMMON_FLAGS.items()]
    res["wunet_sample"] = run_sample("wunet_sample", common_flags + [f"--model_path={found[0]}"],
                                     dict(IDLE, haar_dwt3=3, haar_idwt3=1))
    schema = model_and_diffusion_defaults()
    model, diffusion = common.build_model_and_diffusion(
        {k: v for k, v in stored.items() if k in schema})
    if type(model).__name__ != "WavUNetModel" or not model.ref_compat:
        fail(f"the BEST's sidecar built a {type(model).__name__}")
    common.load_params(found[0], model)
    res["wunet_synthesis_fn"] = eager_vs_graph(torch, np, model, diffusion, batch, "ddpm")
    res["wunet_wavelets"] = wunet_wavelet_ms(torch, model)
    del model
    torch.cuda.empty_cache()

    # (b) the production UNet with attention, from a JAX-layout .ckpt
    cfg = common.production_config(sample_schedule="sampled", diffusion_steps=10,
                                   **ATTENTION_FLAGS)
    model, diffusion = common.build_model_and_diffusion(cfg)
    sd = seeded(torch, model)
    params = jax_params_from_state_dict(sd, model)
    path = os.path.join(tmp, "ckpt_attention", "brats_t1c_BEST_sampled_10.ckpt")
    checkpoints.save_checkpoint(path, {"params": params, "ema_params": (), "step": 0},
                                dict(cfg, contr="t1c"))
    loaded = checkpoints.load_checkpoint(path)
    back, _ = common.build_model_and_diffusion(cfg)
    common.load_params(path, back)
    if not same_tree(np, loaded["params"], params) \
            or any(not torch.equal(back.state_dict()[k], v) for k, v in sd.items()):
        fail("the attention UNet's .ckpt did not read back bit for bit")
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in model.modules())
    res["attention_ckpt"] = {"bytes": os.path.getsize(path), "attention_blocks": n_attn,
                             "n_params": sum(p.numel() for p in model.parameters()),
                             "attention_ds": list(model.attention_resolutions)}
    del back, loaded, params
    flags = [f"--{k}={v}" for k, v in cfg.items()] + [f"--model_path={path}"]
    res["attention_sample_ddpm"] = run_sample(
        "attention_sample_ddpm", flags, dict(IDLE, haar_dwt3=3, haar_idwt3=1))
    res["attention_sample_fuse_conv_dpm"] = run_sample(
        "attention_sample_fuse_conv_dpm",
        flags + ["--fuse_conv=True", "--sampler=dpm++", "--sampling_steps=10"],
        dict(IDLE, haar_dwt3=3, haar_idwt3=1, conv3d_fused_k4b=540, conv3d_wgmma=300,
             conv3d_splitk=240))
    fused, _ = common.build_model_and_diffusion(dict(cfg, fuse_conv=True))
    fused.load_state_dict(sd)
    res["attention_synthesis_fn_ddpm"] = eager_vs_graph(torch, np, model, diffusion, batch, "ddpm")
    res["attention_synthesis_fn_fuse_conv_dpm"] = eager_vs_graph(torch, np, fused, diffusion,
                                                                 batch, "dpm++")
    del fused

    # ms/forward beside the production forward, in turns (a, p, p, a; twice)
    pcfg, psd = seeded_production(torch)
    prod, _ = common.build_model_and_diffusion(pcfg)
    prod.load_state_dict(psd)
    models = {"attention": model.cuda().eval(), "production": prod.cuda().eval()}
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, *LATENT, 32), generator=g, device="cuda").permute(0, 4, 1, 2, 3)
    t = torch.tensor([9], device="cuda")
    times = {name: [] for name in models}
    with torch.inference_mode():
        for m in models.values():
            m(x, t)
        for _ in range(2):
            for name in ("attention", "production", "production", "attention"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = models[name](x, t)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
                if tuple(y.shape) != (1, 8, *LATENT) or not bool(torch.isfinite(y).all()):
                    fail(f"the {name} forward gave a wrong shape or non-finite values")
    res["forward_ms"] = {name: statistics.median(v) for name, v in times.items()}
    res["forward_ms_all"] = times
    del models, model, prod
    torch.cuda.empty_cache()
    return res


def reference_models(torch) -> dict:
    """(name → (module, inputs)) of every new module at a tiny fp32 size,
    seeded weights, on the CPU."""
    from fast_cwdm_tpu_torch.models import unet, wunet

    unet_cfg = dict(image_size=8, in_channels=8, model_channels=16, out_channels=8,
                    num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                    num_groups=8, resblock_updown=True, bottleneck_attention=True,
                    resample_2d=False, num_heads=2)
    wunet_cfg = dict(unet_cfg, num_res_blocks=2, ref_compat=True)
    del wunet_cfg["resblock_updown"]
    encoder_cfg = dict(image_size=16, in_channels=8, model_channels=16, out_channels=5,
                       num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), dims=2,
                       num_groups=8, resblock_updown=True, num_heads=2)
    g = torch.Generator().manual_seed(0)
    x3 = torch.randn((2, 8, 8, 8, 8), generator=g)
    t = torch.tensor([7, 300])
    y = torch.tensor([1, 0])
    cases = {
        "attention_legacy": (unet.UNetModel(**unet_cfg), (x3, t)),
        "attention_new_order": (unet.UNetModel(**unet_cfg, use_new_attention_order=True), (x3, t)),
        "attention_head_channels": (unet.UNetModel(**unet_cfg, num_head_channels=8), (x3, t)),
        "unet_class_cond": (unet.UNetModel(**unet_cfg, num_classes=2), (x3, t, y)),
        "wunet_ref_compat": (wunet.WavUNetModel(**wunet_cfg), (x3, t)),
        "wunet_class_cond": (wunet.WavUNetModel(**wunet_cfg, num_classes=2), (x3, t, y)),
        **{f"encoder_{pool}": (unet.EncoderUNetModel(**encoder_cfg, pool=pool),
                               (torch.randn((2, 8, 16, 16), generator=g), t))
           for pool in ("adaptive", "spatial", "spatial_v2")},
        "super_res": (unet.SuperResModel(**dict(encoder_cfg, in_channels=6, out_channels=3,
                                                resblock_updown=False)),
                      (torch.randn((2, 3, 16, 16), generator=g), t,
                       torch.randn((2, 3, 8, 8), generator=g))),
        "gating_down": (unet.WaveletGatingDownsample(4, 8),
                        (torch.randn((2, 4, 4, 6, 8), generator=g), torch.randn((2, 8), generator=g))),
        "gating_up": (unet.WaveletGatingUpsample(4, 8),
                      (torch.randn((2, 4, 4, 6, 8), generator=g), torch.randn((2, 8), generator=g))),
    }
    for module, _ in cases.values():
        seeded(torch, module)
        module.eval()
    return cases


def phase_models_reference(torch) -> dict:
    """Every new module at a tiny fp32 size on the card against the same
    module on the CPU (which the CPU tests hold against the JAX package):
    same seeded weights and inputs, cuDNN and matmul TF32 off, tolerance
    1e-4."""
    res = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        for name, (module, args) in reference_models(torch).items():
            ref = module(*args)
            got = module.cuda()(*(a.cuda() for a in args))
            torch.cuda.synchronize()
            err = float((got.cpu() - ref).abs().max())
            res[name] = {"shape": list(ref.shape), "max_abs_err": err,
                         "max_abs_output": float(ref.abs().max())}
            if not err <= 1e-4 or not bool(torch.isfinite(got).all()):
                fail(f"{name} on the card disagrees with the CPU: {res[name]}")
    torch.backends.cudnn.allow_tf32 = True
    return {"tol": 1e-4, **res}


API_STEPS = 10  # the sampled schedule of every diffusion_api chain


def api_methods(torch, diffusion, fn, img, cond, img2, seed: int, noise=None) -> dict:
    """The rest of ``GaussianDiffusion``'s API on one model: each method's
    result (tensors), drawn from a generator seeded with ``seed`` on
    ``img``'s device, or from ``noise`` (a dict of the draws each method
    takes, for a card-against-CPU comparison)."""
    dev = img.device
    noise = noise or {}
    gen = lambda: (torch.Generator(device=dev).manual_seed(seed)  # noqa: E731
                   if not noise else None)
    shape = tuple(img.shape)
    kw = lambda name: ({"noise": noise[name][0], "step_noise": noise[name][1]}  # noqa: E731
                       if noise else {"generator": gen()})
    out = {}
    out["sample_known"] = diffusion.sample_known(fn, img, cond=cond, **kw("sample_known"))
    s, i, _, _ = diffusion.p_sample_loop_interpolation(
        fn, shape, img1=img, img2=img2, lambdaint=0.3, cond=cond, **kw("interpolation"))
    out["p_sample_loop_interpolation"], out["interpol"] = s, i
    ddim_kw = {"noise": noise["ddim_known"][0]} if noise else {"generator": gen()}
    s, none, ret = diffusion.ddim_sample_loop_known(fn, shape, img=cond, **ddim_kw)
    if none is not None or ret is not cond:
        fail("ddim_sample_loop_known did not return (sample, None, img)")
    out["ddim_sample_loop_known"] = s
    # the DDIM round trip: encode img with the reverse ODE to t = T-1, decode
    x = img
    for ti in range(diffusion.num_timesteps - 1):
        t = torch.full((shape[0],), ti, dtype=torch.long, device=dev)
        x = diffusion.ddim_reverse_sample(fn, x, t, cond=cond)["sample"]
    out["ddim_reverse_encoded"] = x
    out["ddim_round_trip"] = diffusion.ddim_sample_loop(fn, shape, cond=cond, noise=x)
    bpd = diffusion.calc_bpd_loop(
        lambda x_, t_: x_[..., :8] + 1e-3 * fn(x_, t_), img, cond=cond, clip_denoised=False,
        **({"step_noise": noise["bpd"]} if noise else {"generator": gen()}))
    out.update({f"bpd.{k}": v for k, v in bpd.items()})
    return out


def phase_diffusion_api(torch) -> dict:
    """The rest of ``GaussianDiffusion`` on the card (ROADMAP M9): at the
    production config in bf16 with ``fuse_conv`` (K4b) and the 10-step
    sampled schedule, seeded weights, a condition from three seeded
    volumes: ``sample_known``, ``p_sample_loop_interpolation``,
    ``ddim_sample_loop_known``, a ``ddim_reverse_sample`` round trip (9
    reverse steps, then the 10-step DDIM chain), ``calc_bpd_loop`` (10
    forwards, the model as a 1e-3 correction to an identity predictor so
    the t = 0 decoder term is well-conditioned), and each progressive
    generator against its loop, bit for bit on one generator seed; launch
    counts and seconds of each. Then the same methods at a tiny fp32 size
    (fuse_gn_silu + fuse_conv), card against CPU on the same draws, TF32
    off, tolerance 1e-4 (of the output's scale for the bound's bits and
    the DDIM round trip)."""
    import numpy as np

    from fast_cwdm_tpu_torch import ops
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.ops import wavelet as wv

    res = {}
    cfg, sd = seeded_production(torch, fuse_conv=True)
    model, diffusion = common.build_model_and_diffusion(cfg)
    model.load_state_dict(sd)
    model.cuda().eval()
    fn = lambda x, t: model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(4)
    vols = {m: torch.rand((1, *VOLUME, 1), generator=g, device="cuda")
            for m in ("t1n", "t1c", "t2w", "t2f")}
    with torch.inference_mode():
        reset_counts()
        t0 = time.perf_counter()
        cond = common.prepare_condition(vols, "t1c", device="cuda")
        img = wv.dwt_normalized(vols["t1c"])
        img2 = wv.dwt_normalized(torch.rand((1, *VOLUME, 1), generator=g, device="cuda"))
        out = api_methods(torch, diffusion, fn, img, cond, img2, seed=1)
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = read_counts()
        shape = tuple(img.shape)
        progressive = {}
        for prog, loop in (("p_sample_loop_progressive", "p_sample_loop"),
                           ("ddim_sample_loop_progressive", "ddim_sample_loop")):
            steps = list(getattr(diffusion, prog)(
                fn, shape, cond=cond, generator=torch.Generator(device="cuda").manual_seed(2)))
            ref = getattr(diffusion, loop)(
                fn, shape, cond=cond, generator=torch.Generator(device="cuda").manual_seed(2))
            progressive[prog] = {"steps": len(steps),
                                 "bit_for_bit": bool(torch.equal(steps[-1]["sample"], ref))}
            if len(steps) != API_STEPS or not progressive[prog]["bit_for_bit"]:
                fail(f"{prog} does not end where {loop} ends: {progressive[prog]}")
    res["progressive"] = progressive
    bpd_sum = (out["bpd.vb"].sum(1) + out["bpd.prior_bpd"]).double()
    res["results"] = {k: {"shape": list(v.shape), "finite": bool(torch.isfinite(v).all()),
                          "max_abs": float(v.abs().max())} for k, v in out.items()}
    res["round_trip_max_abs_err"] = float((out["ddim_round_trip"] - img).abs().max())
    res["bpd_total"] = out["bpd.total_bpd"].tolist()
    res["bpd_sum_rel_err"] = float(((out["bpd.total_bpd"].double() - bpd_sum).abs()
                                    / bpd_sum.abs()).max())
    k4b = res["launches"]["conv3d_fused_k4b"]
    res["forwards"] = k4b // 54
    if not all(r["finite"] for r in res["results"].values()) or res["bpd_sum_rel_err"] > 1e-5 \
            or out["bpd.vb"].shape != (1, API_STEPS) or k4b == 0 or k4b % 54 \
            or res["launches"]["haar_dwt3"] == 0:
        fail(f"diffusion_api at the production config: {res}")
    del model, out
    torch.cuda.empty_cache()

    # tiny fp32, card against CPU on the same draws
    rng = np.random.default_rng(0)
    shape = (1, 8, 8, 8, 8)
    draws = lambda n: [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
                       for _ in range(n)]
    noise = {"sample_known": (draws(1)[0], draws(API_STEPS)),
             "interpolation": (draws(1)[0], draws(API_STEPS)),
             "ddim_known": (draws(1)[0],), "bpd": draws(API_STEPS)}
    tin = {k: torch.from_numpy(rng.random(shape[:-1] + (c,)).astype(np.float32))
           for k, c in (("img", 8), ("img2", 8), ("cond", 24))}
    tiny = common.production_config(num_channels=16, num_res_blocks=1, channel_mult="1,2",
                                    num_groups=8, image_size=8, diffusion_steps=API_STEPS,
                                    sample_schedule="sampled", dtype="float32",
                                    fuse_gn_silu=True, fuse_conv=True)

    def to(v, dev):  # a draw, or a tuple or list of them, on dev
        return type(v)(to(a, dev) for a in v) if isinstance(v, (tuple, list)) else v.to(dev)

    outs = {}
    for dev in ("cpu", "cuda"):
        model, diffusion = common.build_model_and_diffusion(tiny)
        model.load_state_dict(seeded(torch, model))
        model.to(dev).eval()
        f = lambda x, t, m=model: m(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)  # noqa: E731
        with torch.inference_mode(), no_tf32(torch):
            outs[dev] = api_methods(torch, diffusion, f, tin["img"].to(dev), tin["cond"].to(dev),
                                    tin["img2"].to(dev), seed=0,
                                    noise={k: to(v, dev) for k, v in noise.items()})
    ref = {}
    for k, v in outs["cpu"].items():
        got = outs["cuda"][k].cpu()
        err = float((got - v).abs().max())
        # 1e-4; relative to the scale for the bound's bits and the DDIM
        # round trip, whose encoded latent grows to ~200 (ε divides by
        # √(1/ᾱ − 1) = 0.01 at t = 0)
        scaled = k.startswith("bpd.") or k.startswith("ddim_r")
        tol = 1e-4 * (max(1.0, float(v.abs().max())) if scaled else 1.0)
        ref[k] = {"max_abs_err": err, "tol": tol, "max_abs": float(v.abs().max())}
        if not err <= tol or not bool(torch.isfinite(got).all()):
            fail(f"diffusion_api {k} on the card disagrees with the CPU: {ref[k]}")
    res["reference_tiny_fp32"] = ref
    return res


# seconds from each torchrun job's launch until its last rank was past
# set-up (process group and CUDA context), by job, from the ranks' clocks
COLD_STARTS: dict = {}
# seconds its last rank to be ready then waited for the go of a job
# started ahead of its phase (0 where the go came first)
GO_WAITS: dict = {}


def torchrun_start(tmp: str, name: str, n: int, child: list, env: dict,
                   config: dict | None = None, gated: bool = False) -> tuple:
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node=n chip_smoke.py <child>`` (n ranks on this host, each
    writing its record to ``tmp/name/rank{r}.json``) in a session of its
    own and return at once (``config``, where given, is written to
    ``tmp/name/config.json`` for the ranks first); :func:`torchrun_finish`
    waits for it, :func:`torchrun_stop` ends it. ``gated``: each rank sets
    itself up (its cold start) and then waits for :func:`torchrun_go`, so
    that a job can be started ahead of its phase."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    out_dir = os.path.join(tmp, name)
    os.makedirs(out_dir, exist_ok=True)
    if config is not None:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(config, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", os.path.join(REPO, "chip_smoke.py"), *child]
    log_path = os.path.join(tmp, f"{name}.log")
    env = dict(os.environ, **env)
    go = os.path.join(out_dir, "go")
    if gated:
        env["CHIP_SMOKE_GO"] = go
    launched = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log, cwd=REPO,
                                start_new_session=True)
    return name, n, proc, log_path, out_dir, launched


def torchrun_go(job: tuple) -> None:
    """Let the ranks of a gated job of :func:`torchrun_start` run on."""
    with open(os.path.join(job[4], "go"), "w"):
        pass


def torchrun_stop(job: tuple) -> None:
    """Kill a job of :func:`torchrun_start` that is still running, its ranks
    with it."""
    kill_tree(job[2])


def torchrun_finish(job: tuple, timeout: int = 300) -> list:
    """Wait for a job of :func:`torchrun_start`; its ranks' records in rank
    order. Fails on a nonzero exit or at ``timeout`` seconds."""
    name, n, proc, log_path, out_dir, launched = job
    torchrun_go(job)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = f"nothing (killed at {timeout} s)"
    finally:
        torchrun_stop(job)
    if rc != 0:
        with open(log_path) as f:
            fail(f"torchrun {name} exited {rc}:\n{f.read()[-4000:]}")
    recs = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    COLD_STARTS[name] = max(r["ready_at"] for r in recs) - launched
    # how long the last rank to be ready waited for the go (0 ungated)
    GO_WAITS[name] = max(0.0, min(r["released_at"] for r in recs)
                         - max(r["ready_at"] for r in recs))
    return recs


def rank_fields(torch) -> dict:
    """This rank's place: rank, world, backend, device."""
    return dict(rank=int(os.environ["RANK"]), world=int(os.environ["WORLD_SIZE"]),
                backend=os.environ.get("FAST_CWDM_DIST_BACKEND", "nccl"),
                device=torch.cuda.current_device())


def rank_ready(torch) -> float:
    """Set this rank up (its process group, pinned to its GPU, and the CUDA
    context); the host clock's time when that is done."""
    from fast_cwdm_tpu_torch.parallel.mesh import setup_distributed

    setup_distributed("cuda")
    torch.cuda.synchronize()
    return time.time()


def rank_record(torch, out_dir: str, rec: dict) -> None:
    rec.update(rank_fields(torch), launches=read_counts(),
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    with open(os.path.join(out_dir, f"rank{rec['rank']}.json"), "w") as f:
        json.dump(rec, f)


_WRITES: list = []  # the checkpoint writes of this process's cli.train runs


def train_record(torch, exact: bool, argv: list, on_done=None) -> dict:
    """One ``cli.train`` run in this rank (exact: as no_tf32(deterministic=
    True), for the run): its step log (loss, s/step, collectives' ms and
    bytes), launches, peak memory, which of its calls wrote checkpoint
    files, and a digest of this rank's parameters; ``on_done`` is called
    with the finished loop."""
    import contextlib
    import gc
    import hashlib

    from fast_cwdm_tpu_torch.cli import train
    from fast_cwdm_tpu_torch.training import checkpoints

    if not hasattr(checkpoints.save_if_best, "smoke_wrapped"):
        for name in ("save_checkpoint", "save_if_best"):
            def wrapped(*a, _f=getattr(checkpoints, name), _n=name, **kw):
                _WRITES.append(_n)
                return _f(*a, **kw)
            wrapped.smoke_wrapped = True
            setattr(checkpoints, name, wrapped)
    first = len(_WRITES)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with no_tf32(torch, deterministic=True) if exact else contextlib.nullcontext():
        loop = train.main(argv)
        torch.cuda.synchronize()
    h = hashlib.sha256()
    for p in loop.state.params.values():
        h.update(p.detach().float().cpu().numpy().tobytes())
    rec = {"step_log": loop.step_log, "steps": loop.state.step, "preempted": loop.preempted,
           "writes": _WRITES[first:], "params_sha256": h.hexdigest(), **rank_fields(torch),
           "launches": read_counts(), "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if on_done is not None:
        on_done(loop)
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def production_model(torch, seed_ckpt: str, **overrides):
    """The production UNet (the production config with ``overrides``) with
    the seeded weights read from ``seed_ckpt``, on the card, in eval mode,
    and its diffusion."""
    from fast_cwdm_tpu_torch.cli import common

    cfg = common.production_config(sample_schedule="sampled", diffusion_steps=10, **overrides)
    model, diffusion = common.build_model_and_diffusion(cfg)
    common.load_params(seed_ckpt, model)
    return model.cuda().eval(), diffusion


def write_seeded_ckpt(torch, path: str) -> str:
    """The seeded production weights as a JAX-layout ``.ckpt`` at ``path``
    (no EMA shadow, step 0), written once for every multi-rank phase: the
    ranks read it instead of seeding 81.5 M parameters each."""
    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.training import checkpoints

    cfg, sd = seeded_production(torch)
    model, _ = common.build_model_and_diffusion(cfg)
    checkpoints.save_checkpoint(path, {"params": jax_params_from_state_dict(sd, model),
                                       "ema_params": (), "step": 0})
    return path


DIST_CASES = 2  # synthetic 240×240×155 cases of the distributed phase


def dist_synthesis_inputs(torch):
    """The global batch of the sharded synthesis: three modalities of two
    seeded volumes → the condition (B = 2) and the brain mask."""
    from fast_cwdm_tpu_torch.cli import common

    g = torch.Generator(device="cuda").manual_seed(6)
    vols = {m: torch.rand((DIST_CASES, *VOLUME, 1), generator=g, device="cuda")
            for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :16] = 0.0  # some background for the mask
    return common.prepare_condition(vols, "t1c", device="cuda"), vols["t1n"]


def dist_synthesis_fn(torch, seed_ckpt: str, mesh=None):
    """The production UNet (seeded, bf16, fuse_conv) as make_synthesis_fn's
    dpm++ 10 chain, sharded over ``mesh`` or not."""
    from fast_cwdm_tpu_torch.cli import common

    model, diffusion = production_model(torch, seed_ckpt, fuse_conv=True)
    return common.make_synthesis_fn(model, diffusion, sampler="dpm++", sampler_steps=10,
                                    device="cuda", mesh=mesh)


def synthesis_record(torch, out_dir: str, seed_ckpt: str) -> dict:
    """``make_synthesis_fn(mesh=)`` in this rank: the whole batch (written
    by every rank, to check they agree), launches, seconds of a first and
    a second call, peak memory."""
    import numpy as np

    from fast_cwdm_tpu_torch.parallel.mesh import local_batch_rows, make_mesh

    mesh = make_mesh()
    run = dist_synthesis_fn(torch, seed_ckpt, mesh)
    cond, mask = dist_synthesis_inputs(torch)
    seconds = []
    for _ in range(2):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = run(cond, mask, torch.Generator(device="cuda").manual_seed(9))
        seconds.append(time.perf_counter() - t0)
    np.save(os.path.join(out_dir, f"synth_rank{mesh.rank}.npy"), img)
    return {"s_per_call": seconds, "shape": list(img.shape),
            "rows": list(local_batch_rows(mesh, DIST_CASES)), **rank_fields(torch),
            "launches": read_counts(), "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def rank_distributed(torch, out_dir: str, config: dict) -> dict:
    """One rank of phase distributed's gloo job: (b) ``cli.train`` exact,
    then (c) the sharded synthesis, in one process."""
    b = train_record(torch, True, config["train_argv"])
    return {"b": b, "c": synthesis_record(torch, out_dir, config["seed"])}


def dist_run_summary(recs: list) -> dict:
    """Per rank: launches per step, s/step (warm median; None for a run of
    one step), all-reduce ms and bytes per step, peak memory."""
    out = []
    for r in recs:
        log = r["step_log"]
        out.append({
            "rank": r["rank"], "world": r["world"], "backend": r["backend"],
            "device": r["device"], "losses": [x["loss"] for x in log],
            "s_per_step_warm": statistics.median(x["seconds_per_step"] for x in log[1:])
            if len(log) > 1 else None,
            "s_per_step_all": [x["seconds_per_step"] for x in log],
            "allreduce_ms_per_step": [x.get("allreduce_ms_per_step") for x in log],
            "allreduce_bytes_per_step": [x.get("allreduce_bytes_per_step") for x in log],
            "max_memory_allocated_bytes": r["max_memory_allocated_bytes"],
            "launches_per_step": {k: v / r["steps"] for k, v in r["launches"].items() if v},
            "writes": r["writes"], "params_sha256": r["params_sha256"]})
    return {"ranks": out}


def flat_tree(tree, prefix: str = "") -> dict:
    """A stored tree as ``{"a/b/c": array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def adam_state(checkpoints, np, ckpt_dir: str) -> dict:
    """The BEST's parameters and its optimizer blob's Adam moments, flat."""
    found = checkpoints.find_best_checkpoint(ckpt_dir, "t1c")
    adam = checkpoints.load_checkpoint(os.path.join(ckpt_dir, "opt_best_t1c.ckpt"))[
        "opt_state"]["0"]
    return {"params": flat_tree(checkpoints.load_with_ema_probe(found[0])["params"]),
            "mu": flat_tree(adam["mu"]), "nu": flat_tree(adam["nu"])}


def compare_runs(np, a: dict, b: dict, steps: int, lr: float) -> dict:
    """Two runs' BEST states: Adam's first moment (linear in the gradients)
    against its largest magnitude; each parameter element against 5e-3·lr
    plus two float32 ulps, with the RMS gradient (Adam's bias-corrected
    √ν) of the elements beyond it: where that is near Adam's eps (1e-8), a
    gradient at float32 noise becomes a step of up to lr."""
    mu_scale = max(float(np.abs(v).max()) for v in b["mu"].values())
    mu_err = max(float(np.abs(a["mu"][k] - v).max()) for k, v in b["mu"].items())
    worst, beyond, rms = [], 0, []
    for k, v in b["params"].items():
        ratio = np.abs(a["params"][k] - v) / (5e-3 * lr + 2.0**-22 * np.abs(v))
        over = ratio > 1.0
        beyond += int(over.sum())
        if over.any():
            rms.append(np.sqrt(b["nu"][k][over] / (1.0 - 0.999**steps)))
        worst.append((float(ratio.max()), k))
    worst.sort(reverse=True)
    rms = np.concatenate(rms) if rms else np.zeros(0)
    return {"params_equal": all(np.array_equal(a["params"][k], v) for k, v in b["params"].items()),
            "adam_mu_max_abs_diff": mu_err, "adam_mu_max_abs": mu_scale,
            "params_worst_ratio": worst[:6], "params_elements_beyond_tol": beyond,
            "grad_rms_of_elements_beyond_tol": {
                q: float(np.quantile(rms, q)) for q in (0.0, 0.5, 0.9, 1.0)} if beyond else {}}


def dist_one_process_runs(torch, tmp: str, data: str, flags: dict) -> dict:
    """Phase distributed (b)'s one process on the ranks' global batch 2,
    with ``--microbatch=1`` and at batch 2: each run's record and its
    Adam state."""
    import numpy as np

    from fast_cwdm_tpu_torch.training import checkpoints

    runs = {}
    for name, extra in (("one_process_microbatch_1", {"microbatch": 1}),
                        ("one_process_batch_2", {})):
        with no_tf32(torch, deterministic=True):
            run = run_train(torch, tmp, name, train_flags(
                data, os.path.join(tmp, f"ckpt_{name}"), DIST_STEPS, **flags, **extra),
                DIST_STEPS)
        runs[name] = run, adam_state(checkpoints, np, os.path.join(tmp, f"ckpt_{name}"))
    return runs


def dist_two_ranks_vs_one(tmp: str, recs: list, one: dict) -> dict:
    """Phase distributed (b): ``cli.train`` as two gloo ranks sharing the
    card, global batch 2, ``DIST_STEPS`` steps with ``--fuse_gn_silu``, fp32
    with TF32 off and cuDNN's deterministic algorithms, from the same
    seeded production weights (``--resume_checkpoint``, so that every layer
    has a gradient from the first step), against one process on the same
    global batch 2: (i) with ``--microbatch=1``, which runs each case at
    batch 1 as a rank does and sums the two gradients once, as the
    all-reduce does: losses, parameters and Adam's moments the same bits;
    (ii) at batch 2 in one pass, whose convolutions reduce in another order:
    losses within 2e-5, and Adam's first moment and the parameters reported
    (``compare_runs``; PERF.md §6). ``recs``: the ranks' records of the
    run, made in the gloo job of :func:`phase_distributed` with ``flags``;
    ``one``: the one-process runs (:func:`dist_one_process_runs`)."""
    import numpy as np

    from fast_cwdm_tpu_torch.training import checkpoints

    steps, lr = DIST_STEPS, 1e-5
    out = check_dist_run("(b)", recs)
    two = adam_state(checkpoints, np, os.path.join(tmp, "ckpt_two"))
    for name, (run, state) in one.items():
        out[name] = {
            **{k: run[k] for k in ("losses", "s_per_step_warm", "max_memory_allocated_bytes",
                                   "launches_per_step")},
            "max_abs_loss_diff": max(abs(a - b) for r in out["ranks"]
                                     for a, b in zip(r["losses"], run["losses"])),
            **compare_runs(np, two, state, steps, lr)}
    exact = out["one_process_microbatch_1"]
    if not (exact["max_abs_loss_diff"] == 0.0 and exact["params_equal"]
            and exact["adam_mu_max_abs_diff"] == 0.0):
        fail(f"(b) two ranks differ from one process accumulating the same rows: {exact}")
    if not out["one_process_batch_2"]["max_abs_loss_diff"] <= 2e-5:
        fail(f"(b) two ranks disagree with one process at batch 2: {out['one_process_batch_2']}")
    out.update(loss_tol_batch_2=2e-5, params_tol="5e-3 lr + 2^-22 |p|, lr 1e-5",
               gradient_bytes=GRAD_BYTES)
    return out


DIST_STEPS = 2  # optimizer steps of each training run of phase distributed
SPATIAL_STEPS = 3  # optimizer steps of phase spatial's bf16 training run
# K1, K2, K3 and its VJP a step of a rank with one case (use_checkpoint)
DIST_LAUNCHES_PER_STEP = {"haar_dwt3": 5, "haar_idwt3": 1, "affine_silu": 71 + REMAT_GN_SITES,
                          "affine_silu_bwd": 71}
GRAD_BYTES = 4 * 81_511_048  # the float32 gradients of the production UNet


def check_dist_run(name: str, recs: list, allreduce_bytes: int = GRAD_BYTES + 4 * 9,
                   same_params: bool = True) -> dict:
    """A training run's ranks: K1, K2, K3 and its VJP each step, one
    all-reduce of ``allreduce_bytes`` a step (the gradients and the 9 loss
    floats), rank 0 alone writing files, and (``same_params``) the same
    parameters on every rank."""
    summary = dist_run_summary(recs)
    for r in summary["ranks"]:
        got = {k: r["launches_per_step"].get(k, 0) for k in DIST_LAUNCHES_PER_STEP}
        if got != DIST_LAUNCHES_PER_STEP:
            fail(f"{name}: rank {r['rank']} launches per step {got}, "
                 f"expected {DIST_LAUNCHES_PER_STEP}")
        if r["allreduce_bytes_per_step"][-1] != allreduce_bytes:
            fail(f"{name}: all-reduce bytes {r['allreduce_bytes_per_step']}")
    if not summary["ranks"][0]["writes"] or any(r["writes"] for r in summary["ranks"][1:]):
        fail(f"{name}: files written by {[r['writes'] for r in summary['ranks']]}")
    if same_params and len({r["params_sha256"] for r in summary["ranks"]}) != 1:
        fail(f"{name}: the ranks' parameters differ")
    return summary


def dist_data(tmp: str) -> tuple[str, dict]:
    """Two synthetic 240×240×155 cases and the ranks' log environment."""
    data = os.path.join(tmp, "data")
    for k in range(DIST_CASES):
        write_case(os.path.join(data, f"0000{k + 1}"), seed=20 + k)
    return data, {"OPENAI_LOGDIR": os.path.join(tmp, "log"), "OPENAI_LOG_FORMAT": "log,csv"}


def dist_one_nccl_rank(tmp: str, data: str, env: dict) -> tuple:
    """Phase distributed (a): ``cli.train`` as one NCCL rank, the
    production config in bf16 with ``--fuse_gn_silu``, started (a job of
    :func:`torchrun_start`, logging to a directory of its own)."""
    flags = train_flags(data, os.path.join(tmp, "ckpt_a"), DIST_STEPS, fuse_gn_silu=True,
                        data_mesh=0)
    return torchrun_start(tmp, "train_nccl_1", 1,
                          ["--rank-train", os.path.join(tmp, "train_nccl_1"), "--", *flags],
                          dict(env, OPENAI_LOGDIR=os.path.join(tmp, "log_a")), gated=True)


def dist_sharded_synthesis(torch, tmp: str, recs: list, seed_ckpt: str) -> dict:
    """Phase distributed (c): ``make_synthesis_fn(mesh=)`` (bf16,
    fuse_conv, dpm++ 10) over two gloo ranks on the card. Held: both ranks
    return the same whole batch, each row equal bit for bit to that row
    synthesized alone at batch 1 on its slice of the same draws, 540 K4b
    a rank. Reported: its difference from the batch synthesized at batch 2
    in one process, where 100 of the 540 convs route to the wgmma kernel
    instead of split-K and the random-weight chain carries the bf16
    differences through 10 steps. ``recs``: the ranks' records of it, made
    in the gloo job of :func:`phase_distributed`."""
    import numpy as np

    imgs = [np.load(os.path.join(tmp, "dist_gloo_2", f"synth_rank{r}.npy")) for r in range(2)]
    if not np.array_equal(imgs[0], imgs[1]):
        fail("(c) the two ranks returned different batches")
    run = dist_synthesis_fn(torch, seed_ckpt)
    cond, mask = dist_synthesis_inputs(torch)
    reset_counts()
    t0 = time.perf_counter()
    whole = run(cond, mask, torch.Generator(device="cuda").manual_seed(9))
    whole_s = time.perf_counter() - t0
    whole_counts = read_counts()
    x_t = torch.randn((DIST_CASES, *LATENT, 8), generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda")
    rows = [run(cond[r:r + 1], mask[r:r + 1], noise=x_t[r:r + 1]) for r in range(DIST_CASES)]
    row_equal = [bool(np.array_equal(imgs[0][r:r + 1], rows[r])) for r in range(DIST_CASES)]
    diff = np.abs(imgs[0] - whole)
    out = {
        "ranks": [{k: r[k] for k in ("rank", "backend", "device", "s_per_call", "rows",
                                     "max_memory_allocated_bytes")}
                  | {"launches": {k: v for k, v in r["launches"].items() if v}} for r in recs],
        "unsharded_batch_2": {"s_per_call": whole_s,
                              "launches": {k: v for k, v in whole_counts.items() if v}},
        "max_abs_diff_vs_batch_2": float(diff.max()),
        "mean_abs_diff_vs_batch_2": float(diff.mean()),
        "rows_bit_for_bit_vs_batch_1": row_equal, "shape": list(imgs[0].shape)}
    for r in recs:
        if r["launches"]["conv3d_fused_k4b"] != 540 or r["launches"]["conv3d_wgmma"] == 0 \
                or r["launches"]["conv3d_splitk"] == 0:
            fail(f"(c) rank {r['rank']} K4b launches {r['launches']}")
    if not (all(row_equal) and np.isfinite(imgs[0]).all()):
        fail(f"(c) sharded synthesis: {out}")
    return out


def phase_distributed(torch, tmp: str, seed_ckpt: str, started: tuple) -> dict:
    """The data axis on the card (ROADMAP M8), through torchrun: (a)
    ``cli.train`` as one rank on NCCL, the production config in bf16 with
    ``--fuse_gn_silu``, ``DIST_STEPS`` steps; (b) two ranks sharing the
    one card (gloo: NCCL takes one rank per GPU), global batch 2, with
    ``--fuse_gn_silu``, against one process on the same global batch 2
    (:func:`dist_two_ranks_vs_one`); (c) ``make_synthesis_fn(mesh=)``
    (bf16, fuse_conv, dpm++ 10) over two ranks against each row
    synthesized alone (:func:`dist_sharded_synthesis`); (b) and (c) in one
    gloo job, each rank running (b) then (c). Per run: launches per kernel and rank, s/step, the all-reduce's
    ms and bytes per step, peak memory per rank, only rank 0 writing
    files, the same parameters on every rank. Two ranks on one card check
    correctness; they do not show scaling. ``started``: both jobs, started
    ahead of the phase (:func:`distributed_start`). The gloo ranks run
    beside this process's one-process runs of (b), then (a) beside the
    rest: the card is shared, so their times are taken under each other's
    load."""
    data, flags, (nccl, gloo) = started
    torchrun_go(gloo)
    one = dist_one_process_runs(torch, tmp, data, flags)  # beside the gloo ranks
    torchrun_go(nccl)  # after them: all three training at once would not fit the card
    recs = torchrun_finish(gloo, timeout=600)
    b = dist_two_ranks_vs_one(tmp, [r["b"] for r in recs], one)
    c = dist_sharded_synthesis(torch, tmp, [r["c"] for r in recs], seed_ckpt)
    a = check_dist_run("(a)", torchrun_finish(nccl))
    return {"a_nccl_world_1": a, "b_gloo_world_2": b, "c_synthesis_gloo_world_2": c,
            "cold_start_s": {k: COLD_STARTS[k] for k in ("train_nccl_1", "dist_gloo_2")},
            "go_wait_s": {k: GO_WAITS[k] for k in ("train_nccl_1", "dist_gloo_2")}}


def distributed_start(tmp: str, seed_ckpt: str) -> tuple:
    """Start phase distributed's two jobs ahead of it, gated (their cold
    starts beside the phases before it): the NCCL rank of (a) and the
    gloo job of (b) and (c)."""
    data, env = dist_data(tmp)
    flags = dict(fuse_gn_silu=True, batch_size=2, dtype="float32",
                 resume_checkpoint=seed_ckpt, data_mesh=0)
    nccl = dist_one_nccl_rank(tmp, data, env)
    gloo = torchrun_start(tmp, "dist_gloo_2", 2, ["--rank-job", "distributed",
                                                   os.path.join(tmp, "dist_gloo_2")],
                          dict(env, FAST_CWDM_DIST_BACKEND="gloo"), gated=True, config={
                              "seed": seed_ckpt, "train_argv": train_flags(
                                  data, os.path.join(tmp, "ckpt_two"), DIST_STEPS, **flags)})
    return data, flags, (nccl, gloo)


SP = 2  # ranks of phase spatial's sp group (gloo, sharing the card)
BF16_FACTOR = 2.0  # tests/test_torch_unet.py: two bf16 runs, against bf16's own error


def spatial_input(torch):
    """Phase spatial's forward input, (1, 32, 112, 112, 80) NCDHW in
    channels_last_3d memory, and t."""
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn((1, *LATENT, 32), generator=g, device="cuda").permute(0, 4, 1, 2, 3)
    return x, torch.tensor([5], device="cuda")


def spatial_volumes(torch):
    """One seeded 224×224×160 case (four modalities, background in t1n)."""
    g = torch.Generator(device="cuda").manual_seed(32)
    vols = {m: torch.rand((1, *VOLUME, 1), generator=g, device="cuda")
            for m in ("t1n", "t1c", "t2w", "t2f")}
    vols["t1n"][:, :16] = 0.0
    vols["t1n"][:, :, -24:] = 0.0  # background across the sp boundary's far side
    return vols


class record_fused_shapes:
    """Inside the block, count the shapes and routes K4b is given
    (``[B, Ci, [X, Y, Z], Co, route]`` as JSON → launches)."""

    def __init__(self):
        import collections

        self.shapes = collections.Counter()

    def __enter__(self):
        from fast_cwdm_tpu_torch.models import unet
        from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

        self.fused = fused = unet.conv3d_fused

        def recording(xx, w, b, **kw):
            bsz, ci, *sp = xx.shape
            self.shapes[json.dumps([bsz, ci, sp, w.shape[-1],
                                    tc.route(xx.dtype, bsz, ci, w.shape[-1], *sp)])] += 1
            return fused(xx, w, b, **kw)

        unet.conv3d_fused = recording
        return self

    def __exit__(self, *exc):
        from fast_cwdm_tpu_torch.models import unet

        unet.conv3d_fused = self.fused

    def table(self) -> list:
        return [json.loads(k) + [n] for k, n in sorted(self.shapes.items())]


def timed_forward(torch, model, x, t, axis) -> tuple:
    """One bf16 forward after a warm one: its output, and its ms, launches,
    collectives by kind and the K4b shapes and routes it reached."""
    torch.cuda.synchronize()
    with record_fused_shapes() as rec:
        model(x, t)  # warm
        torch.cuda.synchronize()
        rec.shapes.clear()
        axis.log.drain(None)
        reset_counts()
        t0 = time.perf_counter()
        out = model(x, t)
        torch.cuda.synchronize()
    return out, {"ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts(),
                 "comm": axis.log.drain_by_kind(), "shapes": rec.table()}


def spatial_record(torch, out_dir: str, seed_ckpt: str) -> dict:
    """Phase spatial (a)-(c) in this rank: its Y slab of the fp32 forward
    (TF32 off), of the bf16 fuse_conv forward (with the fused convs' shapes
    and routes and the launches), and the whole image of a sharded
    fuse_conv dpm++ 10 synthesis (s/volume, launches, halo and reduction
    bytes and ms)."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(sp=SP)
    axis, r = mesh.sp_axis, mesh.process_rank
    y0, y1 = pm.y_slab(mesh, LATENT[1])
    x, t = spatial_input(torch)
    xs = x[:, :, :, y0:y1].contiguous(memory_format=torch.channels_last_3d)
    rec = {"slab": [y0, y1]}
    model, _ = production_model(torch, seed_ckpt, dtype="float32")
    with torch.inference_mode(), no_tf32(torch), pm.sp_active(axis):
        np.save(os.path.join(out_dir, f"a_rank{r}.npy"), model(xs, t).cpu().numpy())
    del model
    model, diffusion = production_model(torch, seed_ckpt, fuse_conv=True)
    with torch.inference_mode(), pm.sp_active(axis):
        out, rec["b"] = timed_forward(torch, model, xs, t, axis)
    np.save(os.path.join(out_dir, f"b_rank{r}.npy"), out.float().cpu().numpy())
    run = common.make_synthesis_fn(model, diffusion, sampler="dpm++", sampler_steps=10,
                                   device="cuda", mesh=mesh)
    vols = spatial_volumes(torch)
    torch.cuda.synchronize()
    axis.log.drain(None)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cond = common.prepare_condition(vols, "t1c", device="cuda", mesh=mesh)
    img = run(cond, vols["t1n"], torch.Generator(device="cuda").manual_seed(9))
    rec["c"] = {"s_per_volume": [time.perf_counter() - t0], "launches": read_counts(),
                "comm": axis.log.drain_by_kind(), "chain": run.chain is None,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    np.save(os.path.join(out_dir, f"c_rank{r}.npy"), img)
    return rec


def rank_spatial(torch, out_dir: str, config: dict) -> dict:
    """One rank of phase spatial's gloo job: (a)-(c), then (d)'s bf16
    ``cli.train --spatial_mesh`` run and its exact fp32 step, in one
    process."""
    rec = spatial_record(torch, out_dir, config["seed"])
    torch.cuda.empty_cache()
    rec["d"] = train_record(torch, False, config["bf16_argv"])
    rec["d_fp32"] = train_record(torch, True, config["fp32_argv"])
    return rec


def slice_routes(torch, F, shapes: list, phase: str, timed: bool = False) -> list:
    """Each distinct fused-conv shape a sharded path reached (sp: halo-
    extended Y; tp: Co over tp), on the kernel ``route`` picks, against
    ``conv3d_fused_plain``; with ``timed``, the routed kernel's ms beside
    cuDNN's (``F.conv3d`` bf16 channels_last_3d, the conv alone) and the
    bound."""
    from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

    out, seen = [], set()
    g = torch.Generator(device="cuda").manual_seed(33)
    for bsz, ci, sp, co, kernel, n in shapes:
        key = (bsz, ci, tuple(sp), co)
        if key in seen:
            continue
        seen.add(key)
        x, w, b, gn = conv_inputs(torch, g, bsz, ci, tuple(sp), co, torch.bfloat16)
        wp = packed_for(tc, kernel, w)
        with torch.inference_mode():
            got = tc.conv3d_fused(x, w, b, gn=gn, block_x=2, w_packed=wp)
            ref = tc.conv3d_fused_plain(x, w, b, gn=gn)
        ratio = tc.tol_ratio(got, ref, x, w, gn)
        row = {"shape": [bsz, ci, *sp], "co": co, "kernel": kernel, "tol_ratio": ratio,
               "max_abs_err": float((got.float() - ref.float()).abs().max()),
               "per_forward": n}
        if timed:
            w_lib = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            b_lib = b.to(torch.bfloat16)
            nb, fl = conv_cost(x, co)
            row["bound_ms"], row["bound_by"] = bound_ms(nb, fl, PEAK_BF16_FLOPS)
            row["ms"] = time_ms(torch, lambda: tc.conv3d_fused(x, w, b, gn=gn, block_x=2,
                                                               w_packed=wp), reps=10)
            row["cudnn_ms"] = time_ms(torch, lambda: F.conv3d(x, w_lib, b_lib, padding=1),
                                      reps=10)
        out.append(row)
        del x, w, b, gn, got, ref
        if not ratio <= 1.0:
            fail(f"{phase}: the {kernel} kernel at {key} disagrees with its plain version "
                 f"({ratio} of {CONV_TOL})")
    torch.cuda.empty_cache()
    return out


def spatial_references(torch, seed_ckpt: str) -> dict:
    """The one-process references of phases spatial and tensor on the same
    input, weights and draws: the fp32 forward (TF32 off), the bf16
    fuse_conv forward with its launches, and the fuse_conv dpm++
    synthesis, eager, with its seconds: 10 evaluations for phase spatial,
    ``TP_SYNTH_EVALS`` for phase tensor."""
    from fast_cwdm_tpu_torch.cli import common

    x, t = spatial_input(torch)
    model, _ = production_model(torch, seed_ckpt, dtype="float32")
    with torch.inference_mode(), no_tf32(torch):
        y32 = model(x, t).cpu().numpy()
    del model
    model, diffusion = production_model(torch, seed_ckpt, fuse_conv=True)
    reset_counts()
    with torch.inference_mode():
        y16 = model(x, t).float().cpu().numpy()
    counts = read_counts()
    vols = spatial_volumes(torch)
    ref = {"y32": y32, "y16": y16, "launches": {k: v for k, v in counts.items() if v},
           "mask": vols["t1n"][..., 0].cpu().numpy()}
    for key, evals in (("whole", 10), ("whole_tp", TP_SYNTH_EVALS)):
        run = common.make_synthesis_fn(model, diffusion, sampler="dpm++", sampler_steps=evals,
                                       device="cuda", cuda_graph=False)
        t0 = time.perf_counter()
        ref[key] = run(common.prepare_condition(vols, "t1c", device="cuda"), vols["t1n"],
                       torch.Generator(device="cuda").manual_seed(9))
        ref[f"{key}_s"] = time.perf_counter() - t0
    del model, run
    torch.cuda.empty_cache()
    return ref


def check_synthesis_image(np, phase: str, imgs: list, ref: dict, key: str = "whole") -> dict:
    """A sharded synthesis: the same finite [0,1] image on every rank, zero
    outside the mask; its difference from the unsharded one (``ref[key]``)."""
    img = imgs[0]
    mask = ref["mask"][:, :, :, :img.shape[3]]
    if not (all(np.array_equal(img, o) for o in imgs[1:]) and img.shape == ref[key].shape
            and np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
            and not np.any(img[mask == 0])):
        fail(f"{phase} (c): the sharded synthesis is not the same finite [0,1] image on every "
             "rank, zero outside the mask")
    diff = np.abs(img - ref[key])
    return {"max_abs_diff_vs_unsharded": float(diff.max()),
            "mean_abs_diff_vs_unsharded": float(diff.mean()), "unsharded_eager_s": ref[f"{key}_s"]}


def spatial_forward_and_synthesis(torch, F, tmp: str, recs: list, ref: dict) -> dict:
    """Phase spatial (a)-(c): the two gloo ranks' records
    (:func:`spatial_record`) against one process on the same input,
    weights and draws (``ref``, :func:`spatial_references`)."""
    import numpy as np

    d = os.path.join(tmp, "spatial_gloo_2")
    y32, y16 = ref["y32"], ref["y16"]
    slabs = {k: np.concatenate([np.load(os.path.join(d, f"{k}_rank{r}.npy"))
                                for r in range(SP)], axis=3) for k in ("a", "b")}
    scale = float(np.abs(y32).max())
    a_err = float(np.abs(slabs["a"] - y32).max())
    bound = BF16_FACTOR * float(np.abs(y16 - y32).max())
    b_err = float(np.abs(slabs["b"] - y16).max())
    res = {"a_fp32_forward": {"max_abs_diff": a_err, "max_abs_output": scale,
                              "tol": 1e-4 * scale},
           "b_bf16_fuse_conv_forward": {
               "max_abs_diff": b_err, "tol": bound, "bf16_vs_fp32": bound / BF16_FACTOR,
               "unsharded_launches": ref["launches"],
               "ranks": [{"rank": r["rank"], "ms": r["b"]["ms"], "shapes": r["b"]["shapes"],
                          "launches": {k: v for k, v in r["b"]["launches"].items() if v},
                          "comm": r["b"]["comm"]} for r in recs]}}
    if not a_err <= 1e-4 * scale:
        fail(f"spatial (a): the sharded fp32 forward differs by {a_err} (scale {scale})")
    if not b_err <= bound:
        fail(f"spatial (b): the sharded bf16 forward differs by {b_err} > {bound}")
    for r in recs:
        got = r["b"]["launches"]
        # the slabs keep the unsharded forward's routes: none 32 wide
        if got["conv3d_fused_k4b"] != 54 or got["conv3d_wgmma_n32"] \
                or sum(got[f"conv3d_{k}"] for k in CONV_KERNELS) != 54:
            fail(f"spatial (b): rank {r['rank']} K4b launches {got}")
    res["b_bf16_fuse_conv_forward"]["routes"] = slice_routes(
        torch, F, [s for r in recs for s in r["b"]["shapes"]], "spatial")
    imgs = [np.load(os.path.join(d, f"c_rank{r}.npy")) for r in range(SP)]
    res["c_synthesis_fuse_conv_dpm10"] = {
        **check_synthesis_image(np, "spatial", imgs, ref),
        "ranks": [{"rank": r["rank"], "s_per_volume": r["c"]["s_per_volume"],
                   "eager": r["c"]["chain"],
                   "launches": {k: v for k, v in r["c"]["launches"].items() if v},
                   "comm_per_forward": {k: [b / 10, ms / 10, n / 10]
                                        for k, (b, ms, n) in r["c"]["comm"].items()},
                   "max_memory_allocated_bytes": r["c"]["max_memory_allocated_bytes"]}
                  for r in recs]}
    for r in recs:
        got = r["c"]["launches"]
        if (got["haar_dwt3"], got["haar_idwt3"], got["conv3d_fused_k4b"]) != (3, 1, 540):
            fail(f"spatial (c): rank {r['rank']} launches {got}")
    return res


def spatial_slab_kernels(torch) -> dict:
    """K1, K2, K3 and the K3 VJP on the shapes the sp path gives them at
    ``SP`` ranks, each against its plain version with the tolerance of its
    unsharded check: K1 on a rank's (224, 224/SP, 160) slab of a volume, K2
    on its (112, 112/SP, 80, 8) slab of the latent, K3 (bf16
    channels_last_3d, as ``fuse_gn_silu`` runs it) and its VJP (bf16 and
    fp32) at every GN+SiLU site of a sharded level, Y halved (levels 0-3;
    level 4 runs whole, at the shapes phases kernels and training check).
    Each slab is the rank's part of one seeded tensor, made contiguous as
    the path makes it."""
    from fast_cwdm_tpu_torch.ops import elementwise_cuda as ec
    from fast_cwdm_tpu_torch.ops import wavelet_cuda as wc

    g = torch.Generator(device="cuda").manual_seed(34)
    out = {}
    vol = torch.rand((1, *VOLUME), generator=g, device="cuda")
    lat = torch.randn((1, *LATENT, 8), generator=g, device="cuda")
    for name, whole, axis, fn, plain in (
            ("haar_dwt3", vol, 2, wc.haar_dwt3, wc.haar_dwt3_plain),
            ("haar_idwt3", lat, 2, wc.haar_idwt3, wc.haar_idwt3_plain)):
        errs = []
        for r in range(SP):
            n = whole.shape[axis] // SP
            x = whole.narrow(axis, r * n, n).contiguous()
            errs.append({"rank": r, "shape": list(x.shape),
                         "max_abs_err": float((fn(x) - plain(x)).abs().max())})
        out[name] = {"tol": 1e-5, "slabs": errs}
        if not all(e["max_abs_err"] <= 1e-5 for e in errs):
            fail(f"spatial: {name} on sp slabs disagrees with its plain version: {errs}")
    k3, vjp = [], []
    for c, (sx, sy, sz) in GN_SITES:
        if sy % 2:
            continue
        sp = (sx, sy // SP, sz)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, *sp, c), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
            gr = torch.randn((1, *sp, c), generator=g, device="cuda").to(dtype).permute(0, 4, 1, 2, 3)
            if dtype == torch.float32:  # as phase_vjp_kernel: fp32 contiguous
                x, gr = x.contiguous(), gr.contiguous()
            a = torch.randn((1, c), generator=g, device="cuda")
            b = torch.randn((1, c), generator=g, device="cuda")
            got, ref = ec.affine_silu_bwd(x, gr, a, b), ec.affine_silu_bwd_plain(x, gr, a, b)
            vjp.append(dict(c=c, spatial=list(sp), dtype=str(dtype).split(".")[-1],
                            tol_ratio=vjp_ratio(torch, ec, got, ref, x, gr, a, b)))
            if dtype == torch.bfloat16:
                y, yr = ec.affine_silu(x, a, b), ec.affine_silu_plain(x, a, b)
                k3.append(dict(c=c, spatial=list(sp), tol_ratio=k3_tol_ratio(torch, y, yr, x, a, b),
                               max_abs_err=float((y.float() - yr.float()).abs().max())))
            del x, gr, got, ref
    out["affine_silu"] = {"tol": "1 bf16 ulp of y + 2^-20 (|x a| + |b|)", "checks": k3}
    out["affine_silu_bwd"] = {"tol": VJP_TOL, "checks": vjp}
    bad = [c for c in k3 + vjp if not c["tol_ratio"] <= 1.0]
    if bad:
        fail(f"spatial: K3 or its VJP on sp slabs disagrees with its plain version: {bad}")
    torch.cuda.empty_cache()
    return out


# Phase spatial (d)'s fp32 step: Adam's first moment (linear in the
# gradients) of two ranks against one process, as a share of its largest
# magnitude. Measured 3.26e-5 on an H100 80GB HBM3 at 700 W; a missing or
# halved sp gradient sum moves it by a share of the order of 0.1-1.
ADAM_MU_RTOL = 1e-3


def spatial_start(tmp: str, seed_ckpt: str) -> tuple:
    """Start phase spatial's gloo job (:func:`rank_spatial`) ahead of the
    phase, gated."""
    data, env = dist_data(tmp)
    exact = dict(fuse_gn_silu=True, dtype="float32", resume_checkpoint=seed_ckpt)
    d = os.path.join(tmp, "spatial_gloo_2")
    return data, torchrun_start(
        tmp, "spatial_gloo_2", SP, ["--rank-job", "spatial", d],
        dict(env, FAST_CWDM_DIST_BACKEND="gloo"), gated=True, config={
            "seed": seed_ckpt,
            "bf16_argv": train_flags(data, os.path.join(tmp, "ckpt_sp"), SPATIAL_STEPS,
                                     fuse_gn_silu=True, spatial_mesh=SP),
            "fp32_argv": train_flags(data, os.path.join(tmp, "ckpt_sp_fp32"), 1,
                                     spatial_mesh=SP, **exact)})


def phase_spatial(torch, F, tmp: str, seed_ckpt: str, ref: dict, started: tuple) -> dict:
    """The sp axis on the card (two gloo ranks share it, so these runs
    check correctness and cost, not scaling): (a) the fp32 production
    forward, TF32 off, sharded against one process (within 1e-4 of the
    output's scale); (b) the bf16 fuse_conv forward (within BF16_FACTOR
    times bf16's own error), each K4b shape and route the halo-extended
    slabs reach held against the plain version; (c) the fuse_conv dpm++ 10
    synthesis, eager, its image checked and its difference from the
    unsharded one reported; (d) ``cli.train --spatial_mesh 2
    --fuse_gn_silu True`` (``SPATIAL_STEPS`` steps: launches of K1, K2, K3
    and its VJP, s/step, memory, halo and all-reduce bytes and ms) and one
    fp32 step against one process (losses within 1e-6, Adam's first moment
    within ``ADAM_MU_RTOL`` of its scale; the parameters reported); all in
    one gloo job, each rank running (a)-(c), then (d)'s two runs; and
    :func:`spatial_slab_kernels` while it runs. Phase tensor's job runs
    beside it all (:func:`tensor_start`): the times of both are taken under
    each other's load. ``ref``: the one-process references
    (:func:`spatial_references`); the one-process fp32 step is added to it
    for phase tensor. ``started``: the job, started ahead of the phase
    (:func:`spatial_start`)."""
    import numpy as np

    from fast_cwdm_tpu_torch.training import checkpoints

    data, job = started
    exact = dict(fuse_gn_silu=True, dtype="float32", resume_checkpoint=seed_ckpt)
    torchrun_go(job)
    try:
        slab = spatial_slab_kernels(torch)  # beside the ranks
        recs = torchrun_finish(job, timeout=900)
    finally:
        torchrun_stop(job)
    # the one process's fp32 step after the sp ranks (the tp ranks, beside
    # it, and the sp ranks' fp32 steps would not all fit the card at once)
    with no_tf32(torch, deterministic=True):
        one = run_train(torch, tmp, "sp_one_process", train_flags(
            data, os.path.join(tmp, "ckpt_sp_one"), 1, **exact), 1)
    res = spatial_forward_and_synthesis(torch, F, tmp, recs, ref)
    res["slab_kernels"] = slab
    res["d_train_fuse_gn_silu"] = check_dist_run("spatial (d)", [r["d"] for r in recs])
    for r, rec in zip(res["d_train_fuse_gn_silu"]["ranks"], recs):
        r.update({f"{k}_per_step": [x.get(f"{k}_per_step") for x in rec["d"]["step_log"]]
                  for k in ("halo_ms", "halo_bytes", "sp_reduce_ms", "sp_reduce_bytes",
                            "sp_gather_ms", "sp_gather_bytes")})
    # one fp32 step from the seeded weights, two ranks against one process
    two = adam_state(checkpoints, np, os.path.join(tmp, "ckpt_sp_fp32"))
    ref["one_fp32_step"] = one
    ref["one_fp32_state"] = adam_state(checkpoints, np, os.path.join(tmp, "ckpt_sp_one"))
    losses = [[x["loss"] for x in r["d_fp32"]["step_log"]] for r in recs]
    res["d_fp32_step_vs_one_process"] = {
        "losses_ranks": losses, "losses_one_process": one["losses"],
        "max_abs_loss_diff": max(abs(a - b) for l in losses for a, b in zip(l, one["losses"])),
        "loss_tol": 1e-6, "params_tol": "5e-3 lr + 2^-22 |p|, lr 1e-5",
        "s_per_step_ranks": [[x["seconds_per_step"] for x in r["d_fp32"]["step_log"]]
                             for r in recs],
        "s_per_step_one_process": one["s_per_step_all"],
        **compare_runs(np, two, ref["one_fp32_state"], 1, 1e-5)}
    step = res["d_fp32_step_vs_one_process"]
    step["adam_mu_rtol"] = ADAM_MU_RTOL
    if not (step["max_abs_loss_diff"] <= 1e-6
            and step["adam_mu_max_abs_diff"] <= ADAM_MU_RTOL * step["adam_mu_max_abs"]):
        fail(f"spatial (d): the fp32 step's loss or Adam's first moment differs from one "
             f"process: {step}")
    res["cold_start_s"] = COLD_STARTS["spatial_gloo_2"]
    res["go_wait_s"] = GO_WAITS["spatial_gloo_2"]
    return res


TP = 2  # ranks of phase tensor's tp group (gloo, sharing the card)
# phase tensor (c)'s dpm++ evaluations: its gates (K1 3, K2 1, 54 K4b an
# evaluation, the image) need no more, and each tp forward's gathers take
# seconds through gloo on one card
TP_SYNTH_EVALS = 3


def save_state_slices(np, path: str):
    """An ``on_done`` for :func:`train_record`: this rank's parameters, EMA
    shadow and Adam moments (its tp slices) as one ``.npz``."""
    def save(loop):
        st, arrays = loop.state, {}
        for k, p in st.params.items():
            arrays[f"params/{k}"] = p.detach().cpu().numpy()
            arrays[f"ema/{k}"] = st.ema_params[0][k].cpu().numpy()
            for m in ("mu", "nu"):
                arrays[f"{m}/{k}"] = st.opt_state[m][k].cpu().numpy()
        np.savez(path, **arrays)

    return save


def rank_tensor(torch, out_dir: str, config: dict) -> dict:
    """One rank of phase tensor's gloo job, the production UNet sharded
    over tp (``shard_params``): (a) the fp32 forward (TF32 off), (b) the
    bf16 fuse_conv forward (ms, launches, the tp gathers, the K4b shapes
    and routes), (c) a fuse_conv dpm++ synthesis of ``TP_SYNTH_EVALS``
    evaluations, eager (s/volume,
    launches, the gathers), (d) ``cli.train --tensor_mesh`` exact in fp32
    for one step (its state's slices saved)."""
    import numpy as np

    from fast_cwdm_tpu_torch.cli import common
    from fast_cwdm_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(tp=TP)
    axis, r = mesh.tp_axis, mesh.process_rank
    x, t = spatial_input(torch)
    model, _ = production_model(torch, config["seed"], dtype="float32")
    pm.shard_params(mesh, model)
    rec = {"params_held": sum(p.numel() for p in model.parameters())}
    with torch.inference_mode(), no_tf32(torch), pm.tp_active(axis):
        np.save(os.path.join(out_dir, f"a_rank{r}.npy"), model(x, t).cpu().numpy())
    del model
    model, diffusion = production_model(torch, config["seed"], fuse_conv=True)
    pm.shard_params(mesh, model)
    with torch.inference_mode(), pm.tp_active(axis):
        out, rec["b"] = timed_forward(torch, model, x, t, axis)
    np.save(os.path.join(out_dir, f"b_rank{r}.npy"), out.float().cpu().numpy())
    del out
    run = common.make_synthesis_fn(model, diffusion, sampler="dpm++",
                                   sampler_steps=TP_SYNTH_EVALS, device="cuda", mesh=mesh)
    vols = spatial_volumes(torch)
    torch.cuda.synchronize()
    axis.log.drain(None)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cond = common.prepare_condition(vols, "t1c", device="cuda", mesh=mesh)
    img = run(cond, vols["t1n"], torch.Generator(device="cuda").manual_seed(9))
    rec["c"] = {"s_per_volume": [time.perf_counter() - t0], "launches": read_counts(),
                "comm": axis.log.drain_by_kind(), "chain": run.chain is None,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    np.save(os.path.join(out_dir, f"c_rank{r}.npy"), img)
    del model, run, cond
    torch.cuda.empty_cache()
    rec["d_fp32"] = train_record(torch, True, config["fp32_argv"], on_done=save_state_slices(
        np, os.path.join(out_dir, f"state_rank{r}.npz")))
    return rec


def tensor_checkpoint(torch, np, tmp: str, seed_ckpt: str) -> dict:
    """Phase tensor (d)'s checkpoint: the ranks' state slices concatenated
    along each sharded axis (numpy, independent of the port's gather),
    written by one process's writer, against the BEST and the optimizer
    blob the tp run wrote, byte for byte; then that BEST loaded into one
    process, every parameter bit for bit the concatenated one. Returns the
    replicated parameters' equality across ranks and the sizes."""
    from fast_cwdm_tpu_torch.models.convert import jax_params_from_state_dict
    from fast_cwdm_tpu_torch.training import checkpoints
    from fast_cwdm_tpu_torch.training.train import make_optimizer

    model, _ = production_model(torch, seed_ckpt, dtype="float32")
    d = os.path.join(tmp, "tensor_gloo_2")
    parts = [np.load(os.path.join(d, f"state_rank{r}.npz")) for r in range(TP)]
    full, replicated_equal, sharded = {g: {} for g in ("params", "ema", "mu", "nu")}, True, 0
    for k, p in model.named_parameters():
        for g in full:
            a = [z[f"{g}/{k}"] for z in parts]
            if a[0].shape == tuple(p.shape):
                replicated_equal &= all(np.array_equal(a[0], o) for o in a[1:])
                full[g][k] = a[0]
            else:
                axis = next(i for i, (m, n) in enumerate(zip(a[0].shape, p.shape)) if m != n)
                full[g][k] = np.concatenate(a, axis)
                sharded += g == "params"
    ours = os.path.join(tmp, "tensor_one_writer")
    os.makedirs(ours, exist_ok=True)
    checkpoints.save_checkpoint(os.path.join(ours, "best.ckpt"), {
        "params": jax_params_from_state_dict(full["params"], model),
        "ema_params": (jax_params_from_state_dict(full["ema"], model),), "step": 1})
    opt = make_optimizer(1e-5, lr_anneal_steps=1)
    checkpoints.save_checkpoint(os.path.join(ours, "opt.ckpt"), {"opt_state": opt.state_to_tree(
        {"count": 1, "mu": {k: torch.from_numpy(v) for k, v in full["mu"].items()},
         "nu": {k: torch.from_numpy(v) for k, v in full["nu"].items()}}, model)})
    found = checkpoints.find_best_checkpoint(os.path.join(tmp, "ckpt_tp_fp32"), "t1c")
    same = {}
    for mine, theirs in (("best.ckpt", found[0]),
                         ("opt.ckpt", os.path.join(tmp, "ckpt_tp_fp32", "opt_best_t1c.ckpt"))):
        with open(os.path.join(ours, mine), "rb") as f, open(theirs, "rb") as g:
            same[mine] = f.read() == g.read()
    from fast_cwdm_tpu_torch.cli import common

    common.load_params(found[0], model)
    loaded = all(np.array_equal(p.detach().cpu().numpy(), full["params"][k])
                 for k, p in model.named_parameters())
    out = {"best_bytes_equal_one_process_writer": same["best.ckpt"],
           "opt_bytes_equal_one_process_writer": same["opt.ckpt"],
           "best_bytes": os.path.getsize(found[0]), "loads_into_one_process_bit_for_bit": loaded,
           "replicated_params_equal_across_ranks": bool(replicated_equal),
           "sharded_tensors": sharded}
    if not (all(same.values()) and loaded and replicated_equal):
        fail(f"tensor (d): the checkpoint written under tp is not one process's: {out}")
    return out


def tensor_start(tmp: str, seed_ckpt: str) -> tuple:
    """Start phase tensor's gloo job (:func:`rank_tensor`; a job of
    :func:`torchrun_start`), gated, to run beside phase spatial."""
    data, env = dist_data(tmp)
    exact = dict(fuse_gn_silu=True, dtype="float32", resume_checkpoint=seed_ckpt)
    return torchrun_start(
        tmp, "tensor_gloo_2", TP, ["--rank-job", "tensor", os.path.join(tmp, "tensor_gloo_2")],
        dict(env, FAST_CWDM_DIST_BACKEND="gloo"), gated=True, config={
            "seed": seed_ckpt,
            "fp32_argv": train_flags(data, os.path.join(tmp, "ckpt_tp_fp32"), 1, tensor_mesh=TP,
                                     **exact)})


def phase_tensor(torch, F, tmp: str, seed_ckpt: str, ref: dict, job: tuple) -> dict:
    """The tp axis on the card: two gloo ranks as one tp group share it
    (so these runs check correctness and cost, not scaling), each holding
    its slices of the parameters ``param_spec`` shards (40,780,680 of
    81,511,048), in one gloo job (:func:`rank_tensor`): (a) the fp32
    forward against one process (within 1e-4 of the output's scale); (b)
    the bf16 fuse_conv forward (within BF16_FACTOR times bf16's own error;
    54 K4b a rank, by route; every distinct Co/2 shape on its routed
    kernel against the plain version, timed beside cuDNN and the bound);
    (c) the fuse_conv dpm++ synthesis of ``TP_SYNTH_EVALS`` evaluations,
    eager (K1 3, K2 1, 54 K4b an evaluation a rank; the same finite [0,1]
    image on both ranks, zero outside the mask; its difference from the
    unsharded one of as many evaluations, s/volume and the tp gathers'
    bytes, ms and calls a forward reported); (d) one fp32 ``fuse_gn_silu``
    step of ``cli.train --tensor_mesh 2`` against one process (losses
    within 1e-6, Adam's first moment within ``ADAM_MU_RTOL`` of its scale,
    the replicated parameters the same bits on both ranks, the checkpoint
    one process's bytes: :func:`tensor_checkpoint`; K1, K2, K3 and its VJP
    each step, rank 0 alone writing; s/step and peak memory a rank beside
    one process's). ``ref``: phase spatial's
    one-process references, the fp32 step's included; ``job``: the ranks,
    started beside phase spatial (:func:`tensor_start`), whose times are
    taken under its load."""
    import numpy as np

    from fast_cwdm_tpu_torch.training import checkpoints

    d = os.path.join(tmp, "tensor_gloo_2")
    recs = torchrun_finish(job, timeout=900)
    y32, y16 = ref["y32"], ref["y16"]
    outs = {k: [np.load(os.path.join(d, f"{k}_rank{r}.npy")) for r in range(TP)]
            for k in ("a", "b")}
    scale = float(np.abs(y32).max())
    a_err = max(float(np.abs(o - y32).max()) for o in outs["a"])
    bound = BF16_FACTOR * float(np.abs(y16 - y32).max())
    b_err = max(float(np.abs(o - y16).max()) for o in outs["b"])
    res = {"params_held_a_rank": [r["params_held"] for r in recs],
           "a_fp32_forward": {"max_abs_diff": a_err, "max_abs_output": scale,
                              "tol": 1e-4 * scale},
           "b_bf16_fuse_conv_forward": {
               "max_abs_diff": b_err, "tol": bound, "bf16_vs_fp32": bound / BF16_FACTOR,
               "unsharded_launches": ref["launches"],
               "ranks": [{"rank": r["rank"], "ms": r["b"]["ms"], "shapes": r["b"]["shapes"],
                          "launches": {k: v for k, v in r["b"]["launches"].items() if v},
                          "comm": r["b"]["comm"]} for r in recs]}}
    if not a_err <= 1e-4 * scale:
        fail(f"tensor (a): the tp fp32 forward differs by {a_err} (scale {scale})")
    if not b_err <= bound:
        fail(f"tensor (b): the tp bf16 forward differs by {b_err} > {bound}")
    if any(r["params_held"] != 40_780_680 for r in recs):
        fail(f"tensor: a rank holds {res['params_held_a_rank']} parameters, not 40,780,680")
    for r in recs:
        got = r["b"]["launches"]
        # by kernel, what route() gave the shapes the rank reached; none
        # on mma.sync, level 0's and level 2's Co/2 on the 32-wide kernel
        r["want"] = {k: sum(s[-1] for s in r["b"]["shapes"] if s[4] == k) for k in CONV_KERNELS}
        if got["conv3d_fused_k4b"] != 54 or r["want"]["mma_sync"] \
                or r["want"]["wgmma_n32"] != sum(TP_N32_CONVS.values()) \
                or any(got[f"conv3d_{k}"] != n for k, n in r["want"].items()):
            fail(f"tensor (b): rank {r['rank']} K4b launches {got}, by route {r['want']} "
                 f"(none may be on mma.sync)")
        if any(s[3] * TP not in (64, 128, 256) for s in r["b"]["shapes"]):
            fail(f"tensor (b): rank {r['rank']} K4b shapes not Co/{TP}: {r['b']['shapes']}")
    res["b_bf16_fuse_conv_forward"]["routes"] = slice_routes(
        torch, F, recs[0]["b"]["shapes"], "tensor", timed=True)
    imgs = [np.load(os.path.join(d, f"c_rank{r}.npy")) for r in range(TP)]
    res["c_synthesis_fuse_conv_dpm"] = {
        "evaluations": TP_SYNTH_EVALS,
        **check_synthesis_image(np, "tensor", imgs, ref, "whole_tp"),
        "ranks": [{"rank": r["rank"], "s_per_volume": r["c"]["s_per_volume"],
                   "eager": r["c"]["chain"],
                   "launches": {k: v for k, v in r["c"]["launches"].items() if v},
                   "comm_per_forward": {k: [b / TP_SYNTH_EVALS, ms / TP_SYNTH_EVALS,
                                            n / TP_SYNTH_EVALS]
                                        for k, (b, ms, n) in r["c"]["comm"].items()},
                   "max_memory_allocated_bytes": r["c"]["max_memory_allocated_bytes"]}
                  for r in recs]}
    for r in recs:
        got = r["c"]["launches"]
        if (got["haar_dwt3"], got["haar_idwt3"], got["conv3d_fused_k4b"]) != (
                3, 1, 54 * TP_SYNTH_EVALS) \
                or any(got[f"conv3d_{k}"] != TP_SYNTH_EVALS * n for k, n in r["want"].items()):
            fail(f"tensor (c): rank {r['rank']} launches {got}, by route "
                 f"{TP_SYNTH_EVALS} × {r['want']} (none may be on mma.sync)")
    # (d): the fp32 step against phase spatial's one process on the same
    # data, weights and flags
    one = ref["one_fp32_step"]
    two = adam_state(checkpoints, np, os.path.join(tmp, "ckpt_tp_fp32"))
    losses = [[x["loss"] for x in r["d_fp32"]["step_log"]] for r in recs]
    step = {
        "losses_ranks": losses, "losses_one_process": one["losses"],
        "max_abs_loss_diff": max(abs(a - b) for l in losses for a, b in zip(l, one["losses"])),
        "loss_tol": 1e-6, "adam_mu_rtol": ADAM_MU_RTOL,
        "s_per_step_ranks": [[x["seconds_per_step"] for x in r["d_fp32"]["step_log"]]
                             for r in recs],
        "s_per_step_one_process": one["s_per_step_all"],
        "max_memory_allocated_bytes_ranks": [r["d_fp32"]["max_memory_allocated_bytes"]
                                             for r in recs],
        "max_memory_allocated_bytes_one_process": one["max_memory_allocated_bytes"],
        "comm_per_step_ranks": [{k: r["d_fp32"]["step_log"][-1].get(k) for k in (
            "allreduce_bytes_per_step", "allreduce_ms_per_step", "tp_gather_bytes_per_step",
            "tp_gather_ms_per_step", "tp_reduce_bytes_per_step", "tp_reduce_ms_per_step")}
            for r in recs],
        **compare_runs(np, two, ref["one_fp32_state"], 1, 1e-5),
        **tensor_checkpoint(torch, np, tmp, seed_ckpt)}
    res["d_fp32_step_vs_one_process"] = step
    if not (step["max_abs_loss_diff"] <= 1e-6
            and step["adam_mu_max_abs_diff"] <= ADAM_MU_RTOL * step["adam_mu_max_abs"]):
        fail(f"tensor (d): the fp32 step's loss or Adam's first moment differs from one "
             f"process: {step}")
    # the sharded gradients reduce over the replica group, which at (data
    # 1, sp 1) is the rank alone: only the replicated ones and the 9 loss
    # floats cross the world; each rank holds its own slices
    res["d_train_fuse_gn_silu"] = check_dist_run(
        "tensor (d)", [r["d_fp32"] for r in recs],
        allreduce_bytes=4 * (81_511_048 - 81_460_736 + 9), same_params=False)
    res["cold_start_s"] = COLD_STARTS["tensor_gloo_2"]
    res["go_wait_s"] = GO_WAITS["tensor_gloo_2"]
    return res


# the conv entries run on one of four hand-written kernels, by
# conv3d_cuda.route
CONV_SOURCES = ("fast_cwdm_tpu_torch/ops/csrc/conv3d_wgmma.cu (bf16, wgmma, levels 0-2; 32-wide "
                "blocks for the tp axis's Co/2 convs) + "
                "fast_cwdm_tpu_torch/ops/csrc/conv3d_splitk.cu (bf16, split-K, levels 3-4) + "
                "fast_cwdm_tpu_torch/ops/csrc/conv3d_tf32.cu (fp32, 3xTF32 wgmma) + "
                "fast_cwdm_tpu_torch/ops/csrc/conv3d.cu (mma.sync; fp32 FFMA off that grid)")
KERNELS = {  # name: (source, replaces, key of its kernels-phase record)
    "haar_dwt3": ("fast_cwdm_tpu_torch/ops/csrc/haar3d.cu",
                  "fast_cwdm_tpu/ops/wavelet_pallas.py:53 (_dwt3_kernel)", "haar_dwt3"),
    "haar_idwt3": ("fast_cwdm_tpu_torch/ops/csrc/haar3d.cu",
                   "fast_cwdm_tpu/ops/wavelet_pallas.py:80 (_idwt3_kernel)", "haar_idwt3"),
    "affine_silu": ("fast_cwdm_tpu_torch/ops/csrc/affine_silu.cu",
                    "fast_cwdm_tpu/ops/elementwise_pallas.py:66 (_affine_silu_kernel)",
                    "affine_silu"),
    "conv3d_fused_k4a": (CONV_SOURCES, "fast_cwdm_tpu/ops/conv3d_pallas.py:36 (_kernel)", "k4a"),
    "conv3d_fused_k4b": (CONV_SOURCES, "fast_cwdm_tpu/ops/conv3d_pallas.py:154 (_blocked_kernel)",
                         "k4b"),
    "conv3d_fused_v4": (CONV_SOURCES, "fast_cwdm_tpu/ops/conv3d_pallas.py:341 (_v4_make_kernel)",
                        "k5"),
    # the fp32 route of the three entries above, by kernel: its record is
    # level 1, 128 → 128, in fp32
    "conv3d_wgmma_tf32": ("fast_cwdm_tpu_torch/ops/csrc/conv3d_tf32.cu",
                          "fast_cwdm_tpu/ops/conv3d_pallas.py:154 (_blocked_kernel, run in fp32; "
                          "also :36 and :341 in fp32)", "fp32"),
    # GroupNorm's statistics replace XLA's fused reductions (no pallas_call)
    "gn_stats": ("fast_cwdm_tpu_torch/ops/csrc/gn_stats.cu",
                 "none: XLA's fused reductions of fast_cwdm_tpu/models/nn.py:76-84 "
                 "(GroupNorm32) and fast_cwdm_tpu/ops/conv3d_pallas.py:311 (group_stats)",
                 "gn_stats"),
    # the K3 VJP replaces plain XLA (a custom VJP with no pallas_call)
    "affine_silu_bwd": ("fast_cwdm_tpu_torch/ops/csrc/affine_silu.cu",
                        "fast_cwdm_tpu/ops/elementwise_pallas.py:155 (_affine_silu_bwd, the VJP of "
                        "the pallas_call at :90)", "vjp_kernel"),
}


RANK_JOBS = {"distributed": rank_distributed, "spatial": rank_spatial, "tensor": rank_tensor}
def evaluation_job(torch, tmp: str) -> dict:
    """Phase evaluation, then phase probes' probes of its BEST
    (:func:`probes_on_best`, under ``probes_on_best``), in the child of
    :func:`evaluation_start`; the child's own seconds under
    ``seconds_in_child``."""
    t0 = time.perf_counter()
    res = phase_evaluation(torch, tmp)
    res["probes_on_best"] = probes_on_best(torch, tmp, res)
    res["seconds_in_child"] = time.perf_counter() - t0
    return res


def evaluation_start(tmp: str) -> tuple:
    """Run :func:`evaluation_job` on ``tmp`` in a child process of this
    script, in a session of its own, beside the phases that follow;
    :func:`evaluation_finish` reads its result, :func:`evaluation_stop`
    ends it."""
    log = open(os.path.join(tmp, "evaluation.log"), "w+")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                             "--evaluation-job", tmp], stdout=log, stderr=log, cwd=REPO,
                            start_new_session=True)
    return tmp, proc, log


def evaluation_stop(job: tuple) -> None:
    kill_tree(job[1])
    job[2].close()


def evaluation_finish(job: tuple, timeout: int = 900) -> dict:
    """Wait for the child of :func:`evaluation_start`; its result. Fails on
    a nonzero exit."""
    tmp, proc, log = job
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = f"nothing (killed at {timeout} s)"
    if rc != 0:
        evaluation_stop(job)
        with open(log.name) as f:
            fail(f"phase evaluation (a child) exited {rc}:\n{f.read()[-6000:]}")
    with open(os.path.join(tmp, "evaluation.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one forward and one train step of each kind with "
                         "torch.profiler")
    # one rank of a multi-rank phase, as torchrun starts it: phase
    # distributed's NCCL run, or a gloo job of phase distributed, spatial
    # or tensor (its DIR holds config.json)
    ap.add_argument("--rank-train", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--rank-job", nargs=2, metavar=("JOB", "DIR"), help=argparse.SUPPRESS)
    # phase evaluation in a child beside the phases that follow (evaluation_start)
    ap.add_argument("--evaluation-job", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("train_argv", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from fast_cwdm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 2
    if not os.path.abspath(_build.__file__).startswith(REPO + os.sep):
        print(f"chip_smoke: the port's package is not this checkout's ({_build.__file__})",
              file=sys.stderr)
        return 2
    if args.rank_train or args.rank_job:
        ready = rank_ready(torch)
        go = os.environ.get("CHIP_SMOKE_GO")  # a job started ahead of its phase
        while go and not os.path.exists(go):
            time.sleep(0.05)
        released = time.time()
        if args.rank_train:
            out_dir, rec = args.rank_train, train_record(torch, False, args.train_argv)
        else:
            job, out_dir = args.rank_job
            with open(os.path.join(out_dir, "config.json")) as f:
                config = json.load(f)
            rec = RANK_JOBS[job](torch, out_dir, config)
        rec["ready_at"], rec["released_at"] = ready, released
        rank_record(torch, out_dir, rec)
        torch.distributed.destroy_process_group()
        return 0
    if args.evaluation_job:
        os.nice(10)  # the phases beside it come first on the host's cores
        res = evaluation_job(torch, args.evaluation_job)
        with open(os.path.join(args.evaluation_job, "evaluation.json"), "w") as f:
            json.dump(res, f)
        return 0

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = phase_start("build")
    per_source = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": per_source})
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    with contextlib.ExitStack() as stack:
        def scratch():
            return stack.enter_context(tempfile.TemporaryDirectory())

        t0 = phase_start("kernels")
        kern = phase_kernels(torch, F)
        kern.update(phase_conv(torch, F))
        emit({"phase": "kernels", "gpu": smi, "seconds": time.perf_counter() - t0, **kern})
        t0 = phase_start("forward")
        fwd = phase_forward(torch, args.profile)
        emit({"phase": "forward", "gpu": smi, "seconds": time.perf_counter() - t0, **fwd})
        t0 = phase_start("synthesis")
        res, counts, conv_counts = phase_synthesis(torch, scratch())
        emit({"phase": "synthesis", "gpu": smi, "seconds": time.perf_counter() - t0, **res})
        # phase evaluation, and phase probes' two probes of its BEST, run in
        # a child beside phases completion to diffusion_api (its trees and
        # BEST then serve phase probes)
        eval_tmp = scratch()
        eval_job = evaluation_start(eval_tmp)
        stack.callback(evaluation_stop, eval_job)
        t0 = phase_start("completion")
        comp = phase_completion(torch, scratch())
        emit({"phase": "completion", "gpu": smi, "seconds": time.perf_counter() - t0, **comp})
        t0 = phase_start("orbax")
        orbax = phase_orbax(torch, scratch(), comp)
        emit({"phase": "orbax", "gpu": smi, "seconds": time.perf_counter() - t0, **orbax})
        t0 = phase_start("training")
        train = phase_training(torch, scratch(), args.profile)
        emit({"phase": "training", "gpu": smi, "seconds": time.perf_counter() - t0, **train})
        kern["vjp_kernel"] = train["vjp_kernel"]
        t0 = phase_start("reference")
        ref = phase_reference(torch)
        emit({"phase": "reference", "seconds": time.perf_counter() - t0, **ref})
        # phase distributed's jobs start here, gated: their cold starts run
        # beside phases models and diffusion_api
        t0 = phase_start("models")
        shared = scratch()
        seed_ckpt = write_seeded_ckpt(torch, os.path.join(shared, "seeded_production.ckpt"))
        seed_s = time.perf_counter() - t0
        dist_tmp = scratch()
        dist_jobs = distributed_start(dist_tmp, seed_ckpt)
        for job in dist_jobs[2]:
            stack.callback(torchrun_stop, job)
        models = phase_models(torch, scratch())
        models["reference"] = phase_models_reference(torch)
        emit({"phase": "models", "gpu": smi, "seconds": time.perf_counter() - t0,
              "seeded_ckpt_s": seed_s, **models})
        t0 = phase_start("diffusion_api")
        api = phase_diffusion_api(torch)
        emit({"phase": "diffusion_api", "gpu": smi, "seconds": time.perf_counter() - t0, **api})
        t0 = phase_start("evaluation")
        evaluation = evaluation_finish(eval_job)
        on_best = evaluation.pop("probes_on_best")
        emit({"phase": "evaluation", "gpu": smi, "seconds": time.perf_counter() - t0,
              **evaluation})
        t0 = phase_start("probes")
        # on evaluation's trees and BEST
        probes = phase_probes(torch, eval_tmp, evaluation, on_best)
        emit({"phase": "probes", "gpu": smi, "seconds": time.perf_counter() - t0, **probes})
        # phases spatial's and tensor's jobs start here, gated: their cold
        # starts run beside phase distributed
        t0 = phase_start("distributed")
        sp_tmp, tp_tmp = scratch(), scratch()
        sp_job = spatial_start(sp_tmp, seed_ckpt)
        tp_job = tensor_start(tp_tmp, seed_ckpt)
        stack.callback(torchrun_stop, sp_job[1])
        stack.callback(torchrun_stop, tp_job)
        dist = phase_distributed(torch, dist_tmp, seed_ckpt, dist_jobs)
        emit({"phase": "distributed", "gpu": smi, "seconds": time.perf_counter() - t0, **dist})
        # phase tensor's ranks run beside phase spatial, its one-process
        # references included; its seconds are those after phase spatial's end
        t0 = phase_start("spatial")
        torchrun_go(tp_job)
        ref = spatial_references(torch, seed_ckpt)
        spatial = phase_spatial(torch, F, sp_tmp, seed_ckpt, ref, sp_job)
        emit({"phase": "spatial", "gpu": smi, "seconds": time.perf_counter() - t0, **spatial})
        t0 = phase_start("tensor")
        tensor = phase_tensor(torch, F, tp_tmp, seed_ckpt, ref, tp_job)
        emit({"phase": "tensor", "gpu": smi, "seconds": time.perf_counter() - t0, **tensor})
        del ref
    emit({"torchrun_jobs": len(COLD_STARTS), "cold_start_s": COLD_STARTS, "go_wait_s": GO_WAITS})
    phases = {k: v for k, v in PHASE_SECONDS.items() if k != "build"}
    emit({"phase_seconds": PHASE_SECONDS, "total": sum(phases.values()),
          "total_with_build": sum(PHASE_SECONDS.values())})

    line = []
    for name, (source, replaces, key) in KERNELS.items():
        k = kern[key]
        # launches: from the main path that runs the kernel (K1-K3: the
        # K3 CLI run; the conv entries: the fused-conv CLI run; the K3 VJP:
        # the fuse_gn_silu training run; the 3×TF32 kernel: phase
        # synthesis's fp32 fuse_conv volume, graphed)
        fp32_volume = res["graph_fp32_fuse_conv"]["launches_per_volume"]
        launches = (train["fuse_gn_silu"]["launches"] if name == "affine_silu_bwd" else
                    fp32_volume if name == "conv3d_wgmma_tf32" else
                    conv_counts if name.startswith("conv3d") else counts)[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "tol": k["tol"],
            "tol_ratio": k.get("tol_ratio"),
            "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
            "kernel": k.get("kernel"), "mma_sync_ms": k.get("mma_sync_ms"),
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
        # per volume of every main-path run: the two CLI syntheses and the
        # completion runs (per case)
        line[-1]["launches_by_path"] = {
            "sample_ddpm_fuse_gn_silu": counts[name], "sample_fuse_conv_dpm": conv_counts[name],
            # phase synthesis: bench.py's faithful leg (make_synthesis_fn,
            # graphed, fuse_clip_projection=False) per volume
            "synthesis_faithful": res["graph_faithful"]["launches_per_volume"][name],
            # phase synthesis's fp32 fuse_conv volume (graphed) and phase
            # forward's fp32 fuse_conv forward
            "synthesis_fp32_fuse_conv": fp32_volume[name],
            "forward_fp32_fuse_conv": fwd["fp32_fuse_conv"]["launches"].get(name, 0),
            **{run: comp[run]["launches"][name] // len(comp[run]["s_per_case"])
               for run in ("complete_a", "complete_b", "sample_auto")},
            **{f"train_{run}_per_step": train[run]["launches_per_step"][name]
               for run in ("unfused", "fuse_gn_silu")},
            # phase orbax: complete_dataset from the port's .orbax (fuse_conv
            # dpm++) per case, cli.train under the orbax backend per step
            "orbax_complete_per_case": orbax["complete"]["launches_per_case"][name],
            "orbax_train_per_step": orbax["train"]["first"]["launches_per_step"][name],
            # phase evaluation: run.sh --mode train per step, run.sh --mode
            # complete per case as written (a) and with fuse_conv (b)
            "evaluation_train_per_step": evaluation["train"]["launches_per_step"][name],
            **{f"evaluation_{run}_per_case": evaluation[run]["launches_per_case"][name]
               for run in ("complete_a", "complete_b")},
            # phase models: the WavUNet's train step and sample, the
            # attention UNet's two samples (per volume)
            "models_wunet_train_per_step": models["wunet_train"]["launches_per_step"][name],
            **{f"models_{run}": models[run]["launches"][name]
               for run in ("wunet_sample", "attention_sample_ddpm",
                           "attention_sample_fuse_conv_dpm")},
            # phase diffusion_api (59 forwards), phase distributed per rank:
            # (a) and (b) per train step, (c) per sharded synthesis call
            "diffusion_api": api["launches"][name],
            **{f"distributed_{run}_rank{r['rank']}_per_step": r["launches_per_step"].get(name, 0)
               for run, key in (("a", "a_nccl_world_1"), ("b", "b_gloo_world_2"))
               for r in dist[key]["ranks"]},
            **{f"distributed_c_rank{r['rank']}": r["launches"].get(name, 0)
               for r in dist["c_synthesis_gloo_world_2"]["ranks"]},
            # phase spatial per rank of the sp group: (b) a forward, (c) a
            # synthesis, (d) a train step
            **{f"spatial_b_rank{r['rank']}": r["launches"].get(name, 0)
               for r in spatial["b_bf16_fuse_conv_forward"]["ranks"]},
            **{f"spatial_c_rank{r['rank']}": r["launches"].get(name, 0)
               for r in spatial["c_synthesis_fuse_conv_dpm10"]["ranks"]},
            **{f"spatial_d_rank{r['rank']}_per_step": r["launches_per_step"].get(name, 0)
               for r in spatial["d_train_fuse_gn_silu"]["ranks"]},
            # phase tensor per rank of the tp group: (b) a forward, (c) a
            # synthesis, (d) the fp32 train step
            **{f"tensor_b_rank{r['rank']}": r["launches"].get(name, 0)
               for r in tensor["b_bf16_fuse_conv_forward"]["ranks"]},
            **{f"tensor_c_rank{r['rank']}": r["launches"].get(name, 0)
               for r in tensor["c_synthesis_fuse_conv_dpm"]["ranks"]},
            **{f"tensor_d_rank{r['rank']}_per_step": r["launches_per_step"].get(name, 0)
               for r in tensor["d_train_fuse_gn_silu"]["ranks"]},
            # phase probes: each probe's whole run
            **{f"probes_{probe}": n.get(name, 0) for probe, n in probes["launches"].items()}}
        if name.startswith("conv3d"):
            line[-1]["launches_by_kernel"] = {
                kn: conv_counts[f"conv3d_{kn}"] for kn in CONV_KERNELS}
            line[-1]["launches_by_kernel_fp32_fuse_conv"] = {
                kn: fp32_volume[f"conv3d_{kn}"] for kn in CONV_KERNELS}
            # the tp path's routes, rank 0: (b) a forward, (c) a volume
            line[-1]["launches_by_kernel_tensor"] = {
                run: {kn: tensor[key]["ranks"][0]["launches"].get(f"conv3d_{kn}", 0)
                      for kn in CONV_KERNELS}
                for run, key in (("b", "b_bf16_fuse_conv_forward"),
                                 ("c", "c_synthesis_fuse_conv_dpm"))}
            line[-1]["tp_co2_per_forward"] = kern["tp_co2_per_forward"]
            line[-1]["deep_levels"] = kern["deep_levels"]
    emit({"kernels": line})
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
