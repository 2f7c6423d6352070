"""Procedural multi-modality MRI phantoms in BraTS geometry (numpy, host).

Port of the JAX package's ``data/phantom.py``: the same generator, draw for
draw, so a seed gives the same arrays bit for bit in both packages; the
files go through this package's own NIfTI writer.

Procedurally generated brains whose four "modalities" are distinct
contrast mappings of SHARED latent anatomy, written in the BraTS-2023
layout the loaders and CLIs consume (``BraTS-GLI-{id}-000-{mod}.nii.gz``,
240×240×155, raw scanner-like intensity range). They stand in for BraTS
cases where none are at hand: the quality and downstream benches
(``scripts/quality_bench.py``, ``scripts/downstream_bench.py``) train and
score on them.

Anatomy model (per case, fully determined by an integer seed):

* smooth latent tissue fields ``c1`` ("WM-ish") and ``c2`` ("GM/CSF-ish")
  from spline-upsampled low-resolution noise;
* a shared fine texture field (same weight in every modality);
* an optional lesion: smooth "edema" blob ``E`` with an "enhancing core"
  ``C`` derived deterministically from E's interior;
* a brain mask: perturbed ellipsoid; background is EXACTLY zero (the
  sampling CLIs mask output by ``cond == 0``).

t1n/t2w/t2f are affine maps of ``(1, c1, c2, E, C, texture)`` with
MRI-motivated signs (T2/FLAIR bright edema, T1 dark CSF); t1c is an EXACT
affine combination of the other three plus a gadolinium-style enhancement
of the core (``T1C_COMBO``). The held-out t1c is therefore pointwise
determined by the three observed modalities up to the enhancement, which
the model must infer from the edema's spatial interior (C = f(E)): the
3→1 completion task is well-posed by construction, and SSIM/PSNR on
held-out phantom cases measures the model and sampler, not dataset noise.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from fast_cwdm_tpu_torch.data import reduce
from fast_cwdm_tpu_torch.data.nifti import Nifti1Image, save

MODALITIES = ("t1n", "t1c", "t2w", "t2f")
RAW_SHAPE = (240, 240, 155)

# rows: (const, c1, c2, E, C, tex) — see module docstring
CONTRAST = {
    "t1n": (0.40, +0.30, -0.12, -0.08, -0.05, 0.05),
    "t2w": (0.30, -0.12, +0.35, +0.22, +0.05, 0.05),
    "t2f": (0.34, -0.06, +0.28, +0.30, -0.10, 0.05),
}
# t1c is an EXACT affine combination of the other three (pre-noise,
# normalized-intensity space) plus gadolinium-style core enhancement:
#   t1c = 0.55·t1n − 0.35·t2w + 0.45·t2f + 0.22 + 0.32·C
# so the 3→1 completion target is pointwise-determined by the inputs —
# except the enhancement, which the model must infer from the edema's
# spatial interior (C = f(E)); that is the learnable "hard part". The
# weights are deliberately spread across all three inputs so that no
# single-modality COPY heuristic scores well (with a 0.9·t1n-dominated
# combo, copy-t1n scored SSIM 0.995 and the benchmark was trivially
# gameable); the constant keeps the combination positive everywhere, so
# the 0.02 intensity floor never clips the target and breaks exactness.
T1C_COMBO = (0.55, -0.35, 0.45, 0.22, 0.32)
LESION_PROB = 0.85


def _smooth_field(rng: np.random.Generator, shape, res: int) -> np.ndarray:
    """Zero-mean unit-std smooth random field: low-res normal noise,
    cubic-spline upsampled to an intermediate grid, then linearly to
    ``shape`` (two-stage: 6x cheaper than one cubic zoom at 240-cube and
    just as smooth — the linear stage interpolates an already-smooth
    field)."""
    from scipy.ndimage import zoom

    base = rng.normal(size=(res, res, max(2, int(res * 0.66)))).astype(
        np.float32
    )
    mid_shape = tuple(min(s, max(b * 2, 48)) for s, b in zip(shape, base.shape))
    mid = zoom(
        base, [m / b for m, b in zip(mid_shape, base.shape)],
        order=3, mode="nearest", grid_mode=True,
    )
    f = zoom(
        mid, [s / m for s, m in zip(shape, mid.shape)],
        order=1, mode="nearest", grid_mode=True,
    )
    f = np.ascontiguousarray(f[: shape[0], : shape[1], : shape[2]])
    # numpy 2.0's float32 summation order on every host (data/reduce.py)
    std = float(reduce.std(f))
    return (f - float(reduce.mean(f))) / (std if std > 0 else 1.0)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def generate_case(
    seed: int, shape=RAW_SHAPE, lesion_prob: float = LESION_PROB,
    rim_texture: float = 0.0, latents: dict | None = None,
) -> dict[str, np.ndarray]:
    """One phantom case: ``{t1n,t1c,t2w,t2f: float32 raw-intensity volume,
    seg: int16 BraTS-label volume}``, deterministic in ``seed``.

    A ``latents`` dict is filled with the brain ``edge`` ramp, the
    enhancing core ``C`` and the per-modality scanner ``gains``: what
    ``scripts/segmenter_calibration.py`` patches t1c's enhancement with.

    ``rim_texture > 0`` adds a case-seeded STOCHASTIC texture to t1c's
    lesion rim that is present in NO other modality and therefore not
    inferable from the inputs (VERDICT r4 #2: the base task's posterior
    is nearly deterministic — t1c = exact affine combo + enhancement
    inferable from lesion geometry — so sampler error never surfaces and
    the quality frontier is flat down to 3 solver evals). With a genuine
    posterior spread, few-eval solvers' over-smoothing becomes measurable
    (see quality_bench's texture-fidelity metric). Drawn from an
    INDEPENDENT rng stream, so rim_texture=0 datasets are bit-identical
    to pre-option ones and all other fields/draws never shift."""
    rng = np.random.default_rng(seed)
    shape = tuple(int(s) for s in shape)
    # broadcast (sparse) grids: full meshgrid materializes 3 volume-size
    # arrays for nothing
    xx = np.arange(shape[0], dtype=np.float32)[:, None, None]
    yy = np.arange(shape[1], dtype=np.float32)[None, :, None]
    zz = np.arange(shape[2], dtype=np.float32)[None, None, :]

    # --- brain mask: perturbed ellipsoid, smooth edge, hard zero outside
    center = [
        s * (0.5 + rng.uniform(-0.02, 0.02)) for s in shape
    ]
    axes = [
        shape[0] * rng.uniform(0.36, 0.42),
        shape[1] * rng.uniform(0.40, 0.46),
        shape[2] * rng.uniform(0.38, 0.44),
    ]
    d2 = (
        ((xx - center[0]) / axes[0]) ** 2
        + ((yy - center[1]) / axes[1]) ** 2
        + ((zz - center[2]) / axes[2]) ** 2
    )
    boundary = _smooth_field(rng, shape, 6)
    mask_field = 1.0 - d2 + 0.12 * boundary
    brain = mask_field > 0.0
    edge = np.clip(mask_field / 0.15, 0.0, 1.0).astype(np.float32)

    # --- latent tissue fields in (0, 1)
    c1 = _sigmoid(1.3 * _smooth_field(rng, shape, 10))
    c2 = _sigmoid(1.3 * _smooth_field(rng, shape, 14))
    tex = np.tanh(_smooth_field(rng, shape, 36)) * 0.5 + 0.5

    # --- lesion: edema blob E, enhancing core C = f(E)
    E = np.zeros(shape, np.float32)
    if rng.uniform() < lesion_prob:
        for _ in range(64):
            lc = [
                rng.uniform(0.25, 0.75) * s for s in shape
            ]
            li = tuple(int(v) for v in lc)
            if mask_field[li] > 0.35:
                break
        lr = [rng.uniform(0.05, 0.12) * s for s in shape]
        ld2 = (
            ((xx - lc[0]) / lr[0]) ** 2
            + ((yy - lc[1]) / lr[1]) ** 2
            + ((zz - lc[2]) / lr[2]) ** 2
        )
        bump = 0.75 + 0.25 * tex
        E = np.clip(1.0 - ld2, 0.0, 1.0) ** 1.5 * bump
        E = E.astype(np.float32)
    C = np.clip((E - 0.55) / 0.45, 0.0, 1.0) ** 1.2

    # --- modalities: affine contrast of shared latents, scanner gain+noise
    base: dict[str, np.ndarray] = {}
    for mod, row in CONTRAST.items():
        b0, w1, w2, we, wc, wt = row
        base[mod] = b0 + w1 * c1 + w2 * c2 + we * E + wc * C + wt * tex
    a1, a2, a3, b0, wc = T1C_COMBO
    base["t1c"] = (
        a1 * base["t1n"] + a2 * base["t2w"] + a3 * base["t2f"]
        + b0 + wc * C
    )
    if rim_texture and E.any():
        # stochastic rim: a band over the outer edema (E in ~(0.05, 0.5)),
        # independent rng → not predictable from the three inputs
        rrng = np.random.default_rng((seed + 1) * 1_000_003)
        R = _smooth_field(rrng, shape, 24)
        band = np.clip((E - 0.05) / 0.25, 0.0, 1.0) * np.clip(
            (0.5 - E) / 0.25, 0.0, 1.0
        )
        base["t1c"] = base["t1c"] + (rim_texture * R * band).astype(
            np.float32
        )
    out: dict[str, np.ndarray] = {}
    gains = {}
    for mod in MODALITIES:
        img = np.clip(base[mod], 0.02, None) * edge
        gain = gains[mod] = rng.uniform(700.0, 1100.0)
        # noise sets the benchmark's irreducible SSIM/R^2 floor (the GT
        # carries it, a perfect model cannot predict it): 0.002 in
        # normalized units keeps the task ceiling ~0.999 while still
        # exercising the denoiser
        noise = rng.normal(0.0, 0.002, size=shape).astype(np.float32)
        # positive floor INSIDE the brain so the zero set is exactly the
        # background in every modality (edge→0 + noise could otherwise
        # zero isolated boundary voxels in one modality only, desyncing
        # the cond==0 brain mask the sampling CLIs rely on)
        vol = np.where(
            brain, np.clip(img + noise, 1e-3, None) * gain, 0.0
        ).astype(np.float32)
        out[mod] = vol

    seg = np.zeros(shape, np.int16)
    seg[E > 0.35] = 2  # edema
    seg[E > 0.55] = 1  # non-enhancing core
    seg[C > 0.25] = 4  # enhancing tumor (BraTS raw labels, pre-remap)
    out["seg"] = seg
    if latents is not None:
        latents.update(edge=edge, C=C, gains=gains)
    return out


def segment_case(
    vols: dict[str, np.ndarray], erode: int | None = None
) -> np.ndarray:
    """Classical stand-in segmenter: modality volumes → BraTS raw labels.

    Plays the role of the pretrained nnUNet in the reference's downstream
    evaluation (`evaluate_synthesis.py:121-154` — its weights are
    unreachable in this air-gapped environment): a model-based inversion
    of the phantom's known contrast physics, exactly as nnUNet is a
    model of real BraTS contrast. Works at ANY per-modality positive
    scale (raw gain, min-max normalized, or synthesized [0,1] output),
    because step 1 re-estimates the scales per case:

    1. Robust least-squares of t1c on (t1n, t2w, t2f, 1) over brain
       voxels. By construction t1c = Σ aᵢ·mᵢ + b + 0.32·C (T1C_COMBO),
       so the fit recovers the cross-modality gain ratios and the
       RESIDUAL isolates the gadolinium-style enhancement:
       ``C_hat = resid / (0.32·g_t1c)`` with ``g_t1c = intercept/0.22``.
       This is the step that makes downstream Dice sensitive to
       synthesis quality — a synthesized t1c with a wrong core produces
       a wrong C_hat.
    2. ET and NCR directly from C_hat: ``C > 0.25`` → 4, ``C > ε`` → 1
       (the GT rules are monotone thresholds of E, and C = g(E) is
       invertible where C > 0; ε absorbs the regression noise floor).
       Edema (E in (0.35, 0.55]) has C = 0, and E is provably NOT
       linearly recoverable — t1c's latent mixing row is an exact affine
       combination of the other three, so the four modalities carry only
       three independent measurements of five latents, and the unique
       nuisance-nulling combination has a zero E coefficient (it IS the
       step-1 residual).
    3. Edema by geometry instead: every lesion has a core (center
       E = bump ≥ 0.75 > 0.55), the blob is an ellipsoid quadric
       ``E = bump·(1−ld2)^1.5``, so fit the axis-aligned quadric
       ``ld2(x,y,z)`` to ``1−(E/b̄)^(2/3)`` over the recovered core
       region and EXTRAPOLATE it outward; threshold the extrapolated E
       at the generator's own 0.35 rule. (The ±12.5 % texture bump the
       fit averages away is this segmenter's honest error floor — the
       analog of nnUNet's own imperfection; it cancels in the
       real-vs-synthesized Dice comparison the benchmark reports.)

    ``erode``: voxels of brain-boundary shell to suppress — the edge
    taper scales all modalities jointly, which the per-voxel affine
    model does not describe. The shell's thickness is RESOLUTION-
    PROPORTIONAL (``edge`` ramps over a fixed fraction of ``mask_field``'s
    dynamic range, i.e. ~0.03·dim voxels), so the default adapts as
    ``max(3, 0.035·max(shape))`` — a fixed 3-voxel erosion left most of
    the shell standing at the full 240³ BraTS shape, which tilted the
    gain regression brain-wide (measured: mean Dice 0.004 at 240³ vs
    0.87 once the shell is gone; the (120,120,78) unit-test shape was
    never affected).
    """
    from scipy.ndimage import binary_erosion

    mods = ("t1n", "t2w", "t2f", "t1c")
    t1n, t2w, t2f, t1c = (np.asarray(vols[m], np.float64) for m in mods)
    if erode is None:
        erode = max(3, int(round(0.035 * max(t1n.shape))))
    brain = (t1n > 0) & (t2w > 0) & (t2f > 0) & (t1c > 0)
    seg = np.zeros(t1n.shape, np.int16)
    if erode:
        brain = binary_erosion(brain, iterations=erode)
    if not brain.any():
        return seg

    # --- step 1: gains + enhancement from the exact t1c combination
    X = np.stack(
        [t1n[brain], t2w[brain], t2f[brain], np.ones(int(brain.sum()))], 1
    )
    y = t1c[brain]
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ coef
    keep = np.abs(resid) <= np.quantile(np.abs(resid), 0.98)
    coef, *_ = np.linalg.lstsq(X[keep], y[keep], rcond=None)  # refit sans core
    a1, a2, a3, b0, wc = T1C_COMBO
    g_t1c = coef[3] / b0
    if g_t1c <= 0:  # degenerate fit (e.g. blank synthesis) → no lesion
        return seg
    gains = np.array(
        [a1 * g_t1c / coef[0], a2 * g_t1c / coef[1],
         a3 * g_t1c / coef[2], g_t1c]
    )
    del gains  # gain ratios fold into coef; only g_t1c is needed below
    C_hat = np.zeros(t1n.shape)
    C_hat[brain] = (y - X @ coef) / (wc * g_t1c)

    # --- step 2: core labels straight from the recovered enhancement
    # noise floor via MAD: the residual's C==0 population is contaminated
    # by brain-edge taper voxels the affine model does not describe; a
    # plain std over that tail once inflated eps past the 0.25 ET
    # threshold and zeroed label 1 entirely
    off = C_hat[brain & (C_hat < 0.01)]
    mad = float(np.median(np.abs(off - np.median(off)))) if off.size else 0.0
    eps = min(0.1, max(0.02, 5.0 * 1.4826 * mad))
    core = C_hat > eps  # ⟺ E > ~0.55 (C = g(E) invertible on its support)
    # a real core is one compact blob of ≥ hundreds of voxels; a no-lesion
    # case leaves only scattered noise-tail voxels above eps — keep the
    # largest connected component and demand it be non-trivial
    if core.any():
        from scipy.ndimage import label as cc_label

        lab, n_cc = cc_label(core)
        sizes = np.bincount(lab.ravel())[1:]
        core = lab == (int(np.argmax(sizes)) + 1)
        if sizes.max() < 20:
            core[:] = False
    if not core.any():
        return seg  # no lesion (or synthesis erased it): all-background

    # --- step 3: edema by quadric extrapolation from the core
    # E = bump·(1−ld2)^1.5 with ld2 an axis-aligned ellipsoid quadric;
    # on the core, E is known via C = ((E−0.55)/0.45)^1.2. Fit on the
    # DEEP core only (C > 0.1): dC/dE → ∞ at C = 0, so eps-shell voxels
    # carry amplified noise that once collapsed the fit into a
    # brain-wide false-edema quadric
    fit_region = core & (C_hat > max(0.1, eps))
    if not fit_region.any():
        fit_region = core
    E_core = 0.55 + 0.45 * np.clip(C_hat[fit_region], 0.0, 1.0) ** (1.0 / 1.2)
    v = 1.0 - (E_core / 0.875) ** (2.0 / 3.0)  # ld2 at bump ≈ mean bump
    ii, jj, kk = np.nonzero(fit_region)
    Q = np.stack(
        [ii * ii, jj * jj, kk * kk, ii, jj, kk, np.ones_like(ii)], 1
    ).astype(np.float64)
    q, *_ = np.linalg.lstsq(Q, v, rcond=None)
    xx = np.arange(t1n.shape[0])[:, None, None]
    yy = np.arange(t1n.shape[1])[None, :, None]
    zz = np.arange(t1n.shape[2])[None, None, :]
    ld2 = (
        q[0] * xx * xx + q[1] * yy * yy + q[2] * zz * zz
        + q[3] * xx + q[4] * yy + q[5] * zz + q[6]
    )
    E_pred = 0.875 * np.clip(1.0 - ld2, 0.0, 1.0) ** 1.5

    # --- the generator's own label rules, most-specific last
    seg[(E_pred > 0.35) & brain] = 2
    seg[core] = 1
    seg[C_hat > 0.25] = 4
    return seg


def write_case(
    case_dir: str,
    seed: int,
    shape=RAW_SHAPE,
    case_id: str | None = None,
    modalities=MODALITIES,
    with_seg: bool = True,
    rim_texture: float = 0.0,
) -> str:
    """Write one case in the BraTS leaf-directory layout the loaders
    discover (`bratsloader.py:29-38`)."""
    os.makedirs(case_dir, exist_ok=True)
    case_id = case_id or os.path.basename(case_dir)
    vols = generate_case(seed, shape, rim_texture=rim_texture)
    for mod in modalities:
        save(
            Nifti1Image(vols[mod], np.eye(4)),
            os.path.join(case_dir, f"BraTS-GLI-{case_id}-000-{mod}.nii.gz"),
        )
    if with_seg:
        save(
            Nifti1Image(vols["seg"], np.eye(4)),
            os.path.join(case_dir, f"BraTS-GLI-{case_id}-000-seg.nii.gz"),
        )
    return case_dir


def write_phantom_dataset(
    root: str,
    n_cases: int,
    start_seed: int = 0,
    shape=RAW_SHAPE,
    workers: int = 4,
    modalities=MODALITIES,
    with_seg: bool = True,
    rim_texture: float = 0.0,
) -> list[str]:
    """Generate ``n_cases`` phantom cases under ``root`` (case directories
    ``{seed:05d}``), in parallel (gzip encoding releases the GIL)."""
    os.makedirs(root, exist_ok=True)
    dirs = []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = []
        for i in range(n_cases):
            seed = start_seed + i
            case_dir = os.path.join(root, f"{seed:05d}")
            dirs.append(case_dir)
            futs.append(
                pool.submit(
                    write_case, case_dir, seed, shape,
                    modalities=modalities, with_seg=with_seg,
                    rim_texture=rim_texture,
                )
            )
        for f in futs:
            f.result()
    return dirs
