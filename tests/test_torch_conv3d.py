"""The port's fused conv entry points (K4a, K4b, K5) against the JAX
package's Pallas kernels run in interpret mode on the CPU, where the port's
wrappers take their plain torch versions. Inputs are made with numpy and
handed to both sides; x goes to the port as a logical NCDHW view
(channels_last_3d memory) of the JAX package's (B, X, Y, Z, C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fast_cwdm_tpu.ops import conv3d_pallas as jc
from fast_cwdm_tpu_torch.ops import conv3d_cuda as tc

torch.set_num_threads(2)


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)


def _last(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 4, 1).numpy()


def _inputs(seed=0, shape=(2, 6, 8, 8, 8), co=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, shape[-1], co))).astype(np.float32)
    b = (0.1 * rng.standard_normal(co)).astype(np.float32)
    return rng, x, w, b


def _gn(rng, x, kind):
    """(mean, inv, scale, bias): None, per channel (C,), or per (B, C)
    from group statistics; the bias is nonzero, so the conv's zero padding
    must come after the prologue."""
    if kind is None:
        return None
    bsz, c = x.shape[0], x.shape[-1]
    if kind == "channel":
        mean = 0.1 * rng.standard_normal(c)
        inv = 0.5 + rng.random(c)
        lead = (c,)
    else:
        mean, inv = (np.asarray(a) for a in jc.group_stats(jnp.asarray(x), 4))
        lead = (bsz, c)
    scale = 1.0 + 0.2 * rng.standard_normal(lead)
    bias = 0.3 + 0.1 * rng.standard_normal(lead)
    return tuple(np.array(a, np.float32) for a in (mean, inv, scale, bias))


def _both(gn):
    if gn is None:
        return None, None
    return tuple(jnp.asarray(a) for a in gn), tuple(torch.from_numpy(a) for a in gn)


@pytest.mark.parametrize(
    "block_x,fold_taps,gn_kind,ci,co",
    [
        *(pytest.param(*case, 8, 16, id="-".join(map(str, case))) for case in (
            (None, True, None),
            (None, False, "channel"),
            (None, True, "batch"),
            (2, True, "channel"),
            (2, True, "batch"),
            (4, True, None),
        )),
        # Co 32: the output width of the 32-wide wgmma kernel (the tp
        # axis's level-0 convs), whose CPU path is this plain version
        pytest.param(2, True, "batch", 16, 32, id="2-True-batch-16to32"),
        pytest.param(None, True, "channel", 16, 32, id="None-True-channel-16to32"),
    ],
)
def test_conv3d_fused_matches_pallas(block_x, fold_taps, gn_kind, ci, co):
    """K4a (block_x None, fold_taps either way) and K4b (block_x 2, 4) at
    tests/test_conv3d_pallas.py's sizes (Ci 8 → Co 16), and at Ci 16 → Co
    32, fp32, atol 1e-5."""
    rng, x, w, b = _inputs(shape=(2, 6, 8, 8, ci), co=co)
    if block_x:
        x = x[:, :4]  # the Pallas slab kernel needs X % block_x == 0
    jgn, tgn = _both(_gn(rng, x, gn_kind))
    ref = jc.conv3d_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), gn=jgn,
                          fold_taps=fold_taps, block_x=block_x, interpret=True)
    before = (tc.conv3d_fused.launches_k4a, tc.conv3d_fused.launches_k4b)
    ours = tc.conv3d_fused(_ncdhw(x), torch.from_numpy(w), torch.from_numpy(b), gn=tgn,
                           fold_taps=fold_taps, block_x=block_x)
    assert (tc.conv3d_fused.launches_k4a, tc.conv3d_fused.launches_k4b) == before
    assert ours.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(_last(ours), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize(
    "ci,co,gn_kind,temb_kind,skip",
    [(8, 8, "batch", "batch", True), (16, 8, "channel", "channel", True), (8, 16, None, None, False)],
)
def test_conv3d_fused_v4_matches_pallas(ci, co, gn_kind, temb_kind, skip):
    """K5 with the temb and skip epilogue, Ci != Co, atol 1e-4 (the JAX
    package's own v4 tolerance)."""
    rng, x, w, b = _inputs(1, (2, 8, 6, 6, ci), co)
    jgn, tgn = _both(_gn(rng, x, gn_kind))
    temb = None
    if temb_kind:
        temb = rng.standard_normal((2, co) if temb_kind == "batch" else (co,)).astype(np.float32)
    sk = rng.standard_normal((2, 8, 6, 6, co)).astype(np.float32) if skip else None
    ref = jc.conv3d_fused_v4(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), gn=jgn,
        temb=None if temb is None else jnp.asarray(temb),
        skip=None if sk is None else jnp.asarray(sk), tx=4, interpret=True,
    )
    before = tc.conv3d_fused_v4.launches
    ours = tc.conv3d_fused_v4(
        _ncdhw(x), torch.from_numpy(w), torch.from_numpy(b), gn=tgn,
        temb=None if temb is None else torch.from_numpy(temb),
        skip=None if sk is None else _ncdhw(sk), tx=4,
    )
    assert tc.conv3d_fused_v4.launches == before
    np.testing.assert_allclose(_last(ours), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("groups", [4, 8])
def test_group_stats_match_jax(groups):
    _, x, _, _ = _inputs(2)
    x = 3.0 + x  # a mean far from 0: E[x²] − E[x]² cancels
    jm, ji = jc.group_stats(jnp.asarray(x), groups)
    tm, ti = tc.group_stats(_ncdhw(x), groups)
    assert tm.shape == ti.shape == (2, 8) and tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5)


def test_pack_conv_weights_matches_jax():
    _, _, w, _ = _inputs(3, (1, 2, 2, 2, 8), 16)
    np.testing.assert_array_equal(
        tc.pack_conv_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jc.pack_conv_weights(jnp.asarray(w))),
    )


def test_plain_version_zero_pads_after_the_prologue():
    """A volume of zeros with a nonzero GN bias: inside, every tap sees
    pro(0) = silu(bias); at the faces, the out-of-volume taps add nothing.
    So a corner voxel sums 8 of the 27 taps and the centre all 27."""
    x = torch.zeros((1, 8, 3, 3, 3)).contiguous(memory_format=torch.channels_last_3d)
    w = torch.ones((3, 3, 3, 8, 8))
    gn = (torch.zeros(8), torch.ones(8), torch.ones(8), torch.full((8,), 0.5))
    y = tc.conv3d_fused(x, w, torch.zeros(8), gn=gn, block_x=2)
    act = 0.5 * torch.sigmoid(torch.tensor(0.5))
    torch.testing.assert_close(y[0, 0, 0, 0, 0], 8 * 8 * act)
    torch.testing.assert_close(y[0, 0, 1, 1, 1], 27 * 8 * act)


def test_cpu_path_stays_differentiable():
    """On the CPU the fused conv is the plain version, differentiable: with
    no prologue its gradients equal F.conv3d's (the card refuses backward:
    tests/test_torch_cuda.py)."""
    _, x, w, b = _inputs(4, (1, 4, 5, 6, 8), 8)
    grads = []
    for conv in (lambda x, w, b: tc.conv3d_fused(x, w, b, block_x=2),
                 lambda x, w, b: F.conv3d(x, w.permute(4, 3, 0, 1, 2), b, padding=1)):
        tx, tw, tb = _ncdhw(x).requires_grad_(), torch.from_numpy(w).requires_grad_(), \
            torch.from_numpy(b).requires_grad_()
        conv(tx, tw, tb).square().sum().backward()
        grads.append([t.grad for t in (tx, tw, tb)])
    for ours, ref in zip(*grads):
        torch.testing.assert_close(ours, ref, atol=1e-4, rtol=1e-5)
