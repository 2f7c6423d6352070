"""Synthesis plumbing: config → model/diffusion, weights (``.ckpt`` or
``.orbax`` of the JAX package, or reference ``.pt``), BEST-checkpoint
discovery, the wavelet condition, and the reverse chain + postprocess as
one callable.

Port of ``fast_cwdm_tpu/cli/common.py`` (ddpm, ddim and dpm++ samplers).
Public functions take and return the JAX package's channels-last
``(B, X, Y, Z, C)`` layout. Everything runs on ``cuda`` unless
``device="cpu"`` is passed; on ``cuda`` the chain's steps are replays of
one captured CUDA graph (``diffusion/graph.py``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fast_cwdm_tpu_torch import resolve_device
from fast_cwdm_tpu_torch.diffusion.gaussian import condition_order
from fast_cwdm_tpu_torch.diffusion.graph import CapturedChain
from fast_cwdm_tpu_torch.models.convert import check_ref_compat, state_dict_from_jax
from fast_cwdm_tpu_torch.models.factory import create_model_and_diffusion, model_and_diffusion_defaults
from fast_cwdm_tpu_torch.ops import wavelet as wv
from fast_cwdm_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_gather_sp,
    local_batch_rows,
    shard_params,
    shard_tensors,
    sp_active,
    tp_active,
    y_slab,
)
from fast_cwdm_tpu_torch.training import checkpoints as ckpt

PRODUCTION_OVERRIDES = dict(
    image_size=112,
    num_channels=64,
    num_res_blocks=2,
    channel_mult="1,2,2,4,4",
    attention_resolutions="",
    in_channels=32,
    out_channels=8,
    dims=3,
    num_groups=32,
    bottleneck_attention=False,
    resample_2d=False,
    use_scale_shift_norm=False,
    additive_skips=False,
    # the training objective is x0-prediction; sampling reads the model
    # output as x_start
    predict_xstart=True,
    mode="i2i",
    # bf16 compute, fp32 params and fp32 GroupNorm statistics
    dtype="bfloat16",
)


def production_config(**overrides) -> dict:
    """The production flag bundle as a config dict."""
    cfg = dict(PRODUCTION_OVERRIDES)
    cfg.update(overrides)
    return cfg


def flagship(in_channels: int = 32, model_channels: int = 64, *,
             device: str | torch.device | None = None, **overrides) -> torch.nn.Module:
    """The production cWDM UNet (81,511,048 parameters; the counterpart of
    the JAX package's ``__graft_entry__._flagship``) on ``device`` (default
    ``cuda``), in the model's own initialisation; ``overrides`` set runtime
    choices such as ``dtype`` (a torch dtype), ``fuse_gn_silu``,
    ``fuse_conv``, ``use_checkpoint`` and ``remat_max_ds`` (the class
    default 0, as JAX's); any other ``UNetModel`` argument (a narrower
    ``num_res_blocks`` or ``channel_mult`` for a CPU check) as well."""
    from fast_cwdm_tpu_torch.models.unet import UNetModel

    dev = resolve_device(device)
    kw = dict(image_size=112, in_channels=in_channels, model_channels=model_channels,
              out_channels=8, num_res_blocks=2, attention_resolutions=(),
              channel_mult=(1, 2, 2, 4, 4), dims=3, num_groups=32, resblock_updown=True,
              bottleneck_attention=False, resample_2d=False)
    kw.update(overrides)
    return UNetModel(**kw).to(dev)


def build_model_and_diffusion(cfg: dict):
    """``(model on the CPU, diffusion)`` for a config dict: a
    ``WavUNetModel`` with ``use_freq``, else a ``UNetModel`` (attention and
    class conditioning as the config says)."""
    return create_model_and_diffusion(**cfg)


def str2bool(s) -> bool:
    """Shared falsy convention: ``0/false/no/off/none/""`` (any case) are
    False, everything else True."""
    if isinstance(s, bool):
        return s
    return str(s).lower() not in ("0", "false", "no", "off", "none", "")


def load_params(path: str, model: torch.nn.Module, *, use_ema: bool = False,
                mesh=None) -> torch.nn.Module:
    """Load a JAX package ``.ckpt`` or ``.orbax``, or a reference-format
    torch ``.pt``, into ``model`` (``strict=True``) and return it.
    ``use_ema`` that cannot be honoured (no EMA shadows in the file) is
    reported, never silently ignored. A model sharded over ``mesh``'s tp
    axis (``shard_params``) loads its slices of the full arrays."""
    return load_params_ex(path, model, use_ema=use_ema, mesh=mesh)[0]


def load_params_ex(path: str, model: torch.nn.Module, *, use_ema: bool = False, mesh=None):
    """Like :func:`load_params` but returns ``(model, ema_applied)``, so a
    caller can tell raw weights from the first EMA shadow. A ``.ckpt`` or
    ``.orbax`` may carry any number of shadows (for ``.orbax``, as many as
    its metadata holds: the JAX package's ``restore_any``).
    Every parameter of the model is loaded, or the load raises: a missing
    or leftover key never loads partially."""
    def load(sd):
        model.load_state_dict(sd if mesh is None else shard_tensors(mesh, model, sd),
                              strict=True)

    if path.endswith(".pt"):
        check_ref_compat(model, "importing .pt weights into")
        if use_ema:
            print(f"[load_params] WARNING: {path} is a torch state_dict with no "
                  "EMA shadows; using the raw parameters")
        load(torch.load(path, map_location="cpu", weights_only=True))
        return model, False
    loaded = ckpt.load_with_ema_probe(path)
    params, applied = loaded["params"], False
    if use_ema:
        if loaded["ema_params"]:
            params, applied = loaded["ema_params"][0], True
        else:
            print(f"[load_params] WARNING: {path} has no EMA shadows; using the raw parameters")
    load(state_dict_from_jax(params, model))
    return model, applied


def prepare_condition(batch: dict, contr: str, wavelet: str = "haar",
                      device: str | torch.device | None = None, mesh=None) -> torch.Tensor:
    """3 known modalities (B, X, Y, Z, 1) → the 24-channel wavelet condition
    (B, X/2, Y/2, Z/2, 24), in the reference's concat order, LLL/3.

    ``mesh`` with an sp axis: each rank transforms its data rows' Y slab
    (kernel K1 on (X, Y/S, Z) slabs), and the slabs and rows are gathered,
    so that every rank returns the whole condition, as without a mesh (the
    ranks of a tp group transform the same slab)."""
    dev = resolve_device(device)
    sharded = mesh is not None and mesh.sp > 1
    if sharded:
        first = np.shape(batch[condition_order(contr)[0]])
        lo, hi = local_batch_rows(mesh, first[0])
        y0, y1 = y_slab(mesh, first[2])
        batch = {m: batch[m][lo:hi, :, y0:y1] for m in condition_order(contr)}
    conds = [
        torch.as_tensor(batch[m], dtype=torch.float32, device=dev)
        for m in condition_order(contr)
    ]
    with sp_active(mesh.sp_axis if sharded else None):
        cond = torch.cat([wv.dwt_normalized(c, wavelet) for c in conds], dim=-1)
    if sharded:
        cond = all_gather_rows(mesh, all_gather_sp(cond, 2, mesh.sp_axis))
    return cond


def load_best_synthesis(checkpoint_dir: str, contr: str, *, dataset: str = "brats",
                        base_cfg: dict | None = None, dtype: str | None = None,
                        use_ema: bool = True, tag: str = "synth", clip_denoised: bool = True,
                        sampler: str = "ddpm", sampler_steps: int | None = None,
                        device: str | torch.device | None = None, mesh=None):
    """Find the BEST checkpoint for ``contr``, merge its stored config,
    build the model and diffusion, load the weights and return
    :func:`make_synthesis_fn`'s ``run``.

    ``base_cfg`` is the starting flag bundle (None: the production preset).
    The stored config wins over it for every key of
    ``model_and_diffusion_defaults()`` except ``dtype``, a runtime choice
    that only ``dtype`` overrides; other stored keys (``contr``, training
    flags) are ignored. A stored ``fuse_gn_silu``/``fuse_conv`` routes the
    UNet through K3/K4b. ``sampler="ddim"`` with ``sampler_steps`` respaces
    the process to ``ddim{N}``. ``mesh`` serves batches over the data axis
    (:func:`make_synthesis_fn`)."""
    found = ckpt.find_best_checkpoint(checkpoint_dir, contr, dataset)
    if found is None:
        raise FileNotFoundError(f"no BEST checkpoint for {contr} in {checkpoint_dir}")
    path, schedule, steps = found
    stored = ckpt.load_checkpoint_config(path) or {}
    cfg = (dict(base_cfg) if base_cfg is not None
           else production_config(sample_schedule=schedule, diffusion_steps=steps))
    schema = set(model_and_diffusion_defaults())
    cfg.update({k: v for k, v in stored.items() if k in schema and k != "dtype"})
    if dtype:
        cfg["dtype"] = dtype
    cfg.update(mode="i2i", sample_schedule=schedule, diffusion_steps=steps)
    if sampler == "ddim" and sampler_steps:
        cfg["timestep_respacing"] = f"ddim{sampler_steps}"
    model, diffusion = build_model_and_diffusion(cfg)
    load_params(path, model, use_ema=use_ema)
    fn = make_synthesis_fn(model, diffusion, clip_denoised=clip_denoised, sampler=sampler,
                           sampler_steps=sampler_steps, device=device, mesh=mesh)
    print(f"[{tag}] {contr}: {os.path.basename(path)} ({schedule}, {steps} steps, "
          f"sampler={sampler})")
    return fn


def make_synthesis_fn(model, diffusion, *, crop_z: int = 155, mesh=None,
                      chunk: int | str | None = "auto", sampler: str = "ddpm",
                      sampler_steps: int | None = None, clip_denoised: bool = True,
                      device: str | torch.device | None = None,
                      cuda_graph: bool | None = None):
    """Build ``run(cond, mask_vol, generator=None, *, noise=None,
    step_noise=None) -> np.ndarray``: the full reverse chain, IDWT with ×3
    LLL, clamp to [0,1], zero where ``mask_vol`` is 0, crop Z to
    ``crop_z``; returns (B, X, Y, crop_z) float32.

    ``sampler``: "ddpm" (ancestral, every step of ``diffusion``), "ddim"
    (eta 0, every step of ``diffusion``; the CLI respaces it to
    ``ddim{N}``) or "dpm++" (DPM-Solver++(2M) with ``sampler_steps``
    evaluations, default min(50, T)).

    ``cuda_graph`` (None: on a CUDA device) runs every step as a replay of
    one captured CUDA graph (``diffusion/graph.py``), the counterpart of
    the JAX package's one jitted program; False runs the eager loops, as
    the CPU always does. Both give the same numbers. ``run.chain`` is the
    :class:`CapturedChain` (None on the eager path).

    ``chunk`` ("auto": 100 where T > 200, else None) runs a ddpm chain in
    segments of ``chunk`` steps with identical numerics: on the graph path
    it bounds how many steps' noise is drawn ahead.

    ``noise``/``step_noise`` inject the initial and per-step noise (for
    parity with the JAX package's key stream); otherwise both are drawn
    from ``generator``, in the same order on both paths.

    ``mesh`` (``parallel.mesh.make_mesh()``, one process per GPU): batched
    serving over the data axis, and over the sp axis a Y slab of every
    volume per rank (the UNet exchanges halos and sums its statistics over
    the sp group), and over the tp axis the model's output channels
    (``model`` is sharded in place by ``shard_params``: every rank of a tp
    group runs the same rows and slab with its slices, and each layer
    gathers its channels). Every rank is called with the whole batch and
    synthesizes its rows (``local_batch_rows``) and its Y slab
    (``y_slab``) of ``cond``, ``mask_vol`` and the noise: x_T and each
    step's noise are drawn for the WHOLE batch from ``generator`` (or the
    given ``noise``/``step_noise`` are sliced), so a volume's noise depends
    on its batch position, not on the mesh. The images are gathered (Y,
    then rows) and every rank returns the whole batch, as the JAX package's
    sharded ``run`` does. The captured chain runs per rank of a data mesh;
    with an sp or a tp axis the chain is eager: its gloo collectives cannot
    be captured in a CUDA graph (``cuda_graph=None`` is then eager and
    ``cuda_graph=True`` raises ``ValueError``).
    """
    if sampler not in ("ddpm", "ddim", "dpm++"):
        raise ValueError(f"sampler must be ddpm, ddim or dpm++, got {sampler!r}")
    if chunk == "auto":
        chunk = 100 if diffusion.num_timesteps > 200 else None
    dev = resolve_device(device)
    sp = mesh.sp_axis if mesh is not None else None
    tp = mesh.tp_axis if mesh is not None else None
    if cuda_graph is None:
        cuda_graph = dev.type == "cuda" and sp is None and tp is None
    elif cuda_graph and (sp is not None or tp is not None):
        raise ValueError(
            "cuda_graph=True with an sp or tp mesh: the halo exchanges, GroupNorm all-reduces "
            "and channel gathers run between kernels of every forward, and gloo's collectives "
            "(host-staged) cannot be captured in a CUDA graph; pass cuda_graph=None or False "
            "(eager)")
    elif cuda_graph and dev.type != "cuda":
        raise ValueError(f"cuda_graph=True needs a CUDA device, got {dev}")
    model = model.to(dev).eval()
    if mesh is not None:
        shard_params(mesh, model)
    steps = sampler_steps or min(50, diffusion.num_timesteps)

    def model_fn(x, t):
        # channels-last → NCDHW view (channels_last_3d memory) and back
        return model(x.permute(0, 4, 1, 2, 3), t).permute(0, 2, 3, 4, 1)

    chain = CapturedChain(diffusion, model_fn, sampler, steps=steps, clip_denoised=clip_denoised,
                          parameters=model.parameters()) if cuda_graph else None

    @torch.inference_mode()
    def run(cond, mask_vol, generator: torch.Generator | None = None, *,
            noise=None, step_noise=None) -> np.ndarray:
        cond = torch.as_tensor(cond, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask_vol, device=dev)
        as_dev = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
            a, dtype=torch.float32, device=dev)
        noise, step_noise = as_dev(noise), as_dev(step_noise)
        shape = (cond.shape[0], *cond.shape[1:-1], diffusion.target_channels)
        if mesh is not None:
            lo, hi = local_batch_rows(mesh, shape[0])
            y0, y1 = y_slab(mesh, shape[2])  # of the latent; 2·y0, 2·y1 in the image
            if noise is None:
                noise = torch.randn(shape, generator=generator, device=dev)
            n_steps = diffusion.num_timesteps
            if sampler == "ddpm":
                step_noise = (_RowsOfGlobalNoise(n_steps, shape, (lo, hi, y0, y1), generator,
                                                 dev)
                              if step_noise is None else step_noise[:, lo:hi, :, y0:y1])
            cond, noise = cond[lo:hi, :, y0:y1], noise[lo:hi, :, y0:y1]
            mask = mask[lo:hi, :, 2 * y0: 2 * y1]
            shape = (hi - lo, shape[1], y1 - y0, *shape[3:])
        kw = dict(cond=cond, noise=noise, generator=generator)
        with sp_active(sp), tp_active(tp):
            if chain is not None:
                sample = chain(shape, step_noise=step_noise, chunk=chunk, **kw)
            elif sampler == "dpm++":
                sample = diffusion.dpm_solver_pp_loop(model_fn, shape, steps=steps, device=dev,
                                                      clip_denoised=clip_denoised, **kw)
            else:
                kw.update(step_noise=step_noise, device=dev, clip_denoised=clip_denoised)
                sample = (diffusion.ddim_sample_loop(model_fn, shape, **kw) if sampler == "ddim"
                          else diffusion.p_sample_loop(model_fn, shape, chunk_size=chunk, **kw))
            img = torch.clamp(wv.idwt_normalized(sample, 1, diffusion.wavelet), 0.0, 1.0)
        img = torch.where(mask == 0, 0.0, img)
        if mesh is not None:
            img = all_gather_rows(mesh, all_gather_sp(img, 2, sp))
        return img[..., 0].cpu().numpy()[:, :, :, :crop_z]

    run.chain = chain
    return run


class _RowsOfGlobalNoise:
    """The ddpm chain's per-step noise on one rank of a mesh: step k's noise
    is drawn for the whole batch (``shape``) from ``generator``, in step
    order, and the rank keeps rows ``[lo, hi)`` and Y ``[y0, y1)``
    (``rows``). A sequence of ``n`` steps
    whose items are drawn when read, each once and in order, as the chains
    read ``step_noise``; a slice is a view that continues the same draws."""

    def __init__(self, n, shape, rows, generator, device, offset=0, drawn=None):
        self.n, self.shape, self.rows = n, shape, rows
        self.generator, self.device, self.offset = generator, device, offset
        self._drawn = drawn if drawn is not None else [0]

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, k):
        if isinstance(k, slice):
            start, stop, _ = k.indices(self.n)
            return _RowsOfGlobalNoise(max(stop - start, 0), self.shape, self.rows,
                                      self.generator, self.device, self.offset + start,
                                      self._drawn)
        if self.offset + k != self._drawn[0]:
            raise IndexError(f"step noise {self.offset + k} read out of order "
                             f"(next is {self._drawn[0]})")
        self._drawn[0] += 1
        lo, hi, y0, y1 = self.rows
        noise = torch.randn(self.shape, generator=self.generator, device=self.device)
        return noise[lo:hi, :, y0:y1]


def subject_id_from_path(path: str) -> str:
    """The case directory name."""
    d = os.path.dirname(path)
    return os.path.basename(d) if d else os.path.basename(path)[:19]


class AsyncWriter:
    """Small write-behind pool: NIfTI gzip encodes overlap the next case's
    sampling. The backlog is bounded (``max_pending``); ``drain()`` waits
    for the rest and returns the number of failed jobs, ``drain_failed()``
    their tags."""

    def __init__(self, max_workers: int = 2, max_pending: int = 8, label: str = "write"):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._pending: list = []
        self._max_pending = max_pending
        self._label = label
        self._failed: list[str] = []

    def _resolve(self, tag, fut) -> None:
        try:
            fut.result()
        except Exception as e:  # noqa: BLE001 — one failed case must not stop the run
            print(f"[{self._label}] FAILED {tag}: {e}")
            self._failed.append(tag)

    def submit(self, tag: str, fn, *args, **kwargs) -> None:
        while len(self._pending) >= self._max_pending:
            self._resolve(*self._pending.pop(0))
        self._pending.append((tag, self._pool.submit(fn, *args, **kwargs)))

    def drain(self) -> int:
        return len(self.drain_failed())

    def drain_failed(self) -> list[str]:
        """Wait for all jobs; the tags of the failed ones (so a caller counts
        a case whose write and copy both fail once)."""
        for tag, fut in self._pending:
            self._resolve(tag, fut)
        self._pending.clear()
        self._pool.shutdown(wait=True)
        failed, self._failed = self._failed, []
        return failed
