"""skix_torch's connected components, EDT, hole filling and the masklet's
frame step with ``fill_holes=True`` against skix on the CPU, from the same
numpy inputs.

Tolerances: labels, sizes, distances and filled logits equal (the same
integer sweeps, the same float32 min-plus sums; a filled pixel is ±0.1
exactly); the masklet's frame step as the masklet's other twins: the
lifecycle's integer and bool state equal, float32 outputs to 1e-4 of
their scale (the trained tracker's logits reach ~30).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import _CHEAP, close_scaled, jit0

FIXTURE = Path(__file__).parent / "fixtures" / "tracker_tiny.npz"
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))


def _spiral(n: int) -> np.ndarray:
    """A one-pixel-wide square spiral walled off by one-pixel gaps: one
    component whose path is ~n²/2 pixels long."""
    m = np.zeros((n, n), bool)
    top, left, bottom, right = 0, 0, n - 1, n - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        if top + 2 <= bottom:
            m[bottom, left:right + 1] = True
        if left + 2 <= right and top + 2 <= bottom:
            m[top + 2:bottom + 1, left] = True
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
        if top <= bottom:
            m[top - 1, left] = True       # the link into the next ring
    return m


def _masks(seed: int, n: int = 4, hw=(20, 23)) -> np.ndarray:
    r = np.random.default_rng(seed)
    return r.random((n, *hw)) < np.linspace(0.3, 0.7, n)[:, None, None]


@pytest.fixture(scope="module")
def skix_cc():
    from skix.ops.connected_components import connected_components

    return jax.jit(jax.vmap(connected_components)).lower(
        jnp.zeros((5, 20, 23), bool)).compile(compiler_options=_CHEAP)


def test_connected_components_match_skix(skix_cc):
    from skix_torch.ops.connected_components import connected_components

    m = np.concatenate([_masks(1), np.zeros((1, 20, 23), bool)])
    want = np.asarray(skix_cc(jnp.asarray(m)))
    got = connected_components(torch.as_tensor(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_connected_components_cap_binds_as_in_skix():
    """A long spiral needs more than 64 sweeps: both stop at the cap with
    the same (unfinished) labels, which a converged labelling (union-find's
    roots) would not give."""
    from skix.ops.connected_components import connected_components as skix_cc
    from skix_torch.ops.connected_components import connected_components

    m = _spiral(41)
    want = np.asarray(jax.jit(skix_cc).lower(jnp.asarray(m)).compile(
        compiler_options=_CHEAP)(jnp.asarray(m)))
    got = connected_components(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, want)
    done = connected_components(torch.as_tensor(m), max_iters=10_000).numpy()
    assert len(np.unique(done[m])) == 1
    assert len(np.unique(got[m])) > 1          # the cap bound


def test_component_sizes_match_skix(skix_cc):
    from skix.ops.connected_components import component_sizes as skix_sizes
    from skix_torch.ops.connected_components import (component_sizes,
                                                     connected_components)

    m = np.concatenate([_masks(2), _masks(3, 1)])
    labels = np.asarray(skix_cc(jnp.asarray(m)))
    roots, sizes = jit0(jax.vmap(lambda x: skix_sizes(x, 6)))(
        jnp.asarray(labels))
    got_r, got_s = component_sizes(
        connected_components(torch.as_tensor(m)), 6)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(roots))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(sizes))


@pytest.mark.parametrize("chunk", [None, 5000])
def test_edt_matches_skix_bit_for_bit(chunk, monkeypatch):
    """Equal to skix's float32 values, whole or in chunks of rows."""
    from skix.ops.edt import edt as skix_edt
    from skix.ops.edt import signed_edt as skix_signed
    from skix_torch.ops import edt as E

    if chunk is not None:
        monkeypatch.setattr(E, "_CHUNK_ELEMS", chunk)
    m = _masks(4, 3, (17, 29))
    m[2] = False                                  # no foreground at all
    np.testing.assert_array_equal(E.edt(torch.as_tensor(m)).numpy(),
                                  np.asarray(jit0(skix_edt)(jnp.asarray(m))))
    np.testing.assert_array_equal(
        E.signed_edt(torch.as_tensor(m[0])).numpy(),
        np.asarray(jit0(skix_signed)(jnp.asarray(m[0]))))


def _hole_logits(seed: int) -> np.ndarray:
    """Logit maps with objects, small holes in them and small sprinkles
    around them."""
    r = np.random.default_rng(seed)
    ys, xs = np.mgrid[:24, :24]
    out = []
    for _ in range(4):
        cy, cx, rad = r.uniform(6, 18), r.uniform(6, 18), r.uniform(4, 9)
        lg = np.where((ys - cy) ** 2 + (xs - cx) ** 2 < rad ** 2, 3.0, -3.0)
        lg = lg + r.normal(0, 0.3, lg.shape)
        lg[r.random(lg.shape) < 0.04] *= -1       # holes and sprinkles
        out.append(lg)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("max_area,fill,sprinkles",
                         [(16, True, True), (2, True, False),
                          (40, False, True), (0, True, True)])
def test_fill_holes_matches_skix(max_area, fill, sprinkles):
    from skix.ops.masks import fill_holes_in_mask_scores as skix_fill
    from skix_torch.ops.masks import fill_holes_in_mask_scores

    lg = _hole_logits(5)
    want = jit0(jax.vmap(lambda x: skix_fill(x, max_area, fill, sprinkles)))(
        jnp.asarray(lg))
    got = fill_holes_in_mask_scores(torch.as_tensor(lg), max_area, fill,
                                    sprinkles)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_area:
        assert not np.array_equal(got.numpy(), lg)


def test_masklet_frame_core_fill_holes_matches_skix():
    """Two frames of the masklet's step with ``fill_holes=True`` on the
    committed 112 px tracker (a spawn, then a tracked frame whose tracker
    masks go through the fill), from the same detector outputs."""
    import make_tracker_fixture as mtf

    from skix.tracking import masklet as SM
    from skix.tracking.memory_tracker import MaskMemoryTracker as SkixTrk
    from skix.tracking.memory_tracker import MemoryBank as SkixBank
    from skix_torch.tracking import masklet as PM
    from skix_torch.tracking.fixture import load_tracker_fixture

    _, trk_vars = mtf.load_fixture(FIXTURE)
    _, port = load_tracker_fixture(FIXTURE, device="cpu")
    skix_trk = SkixTrk(features=48, num_heads=2, mem_slots=3)
    frames, _, _, _ = mtf.synth_clip(77, T=2, n_obj=2)
    holes = _hole_logits(6)[:, 5:19, 5:19] * 2.0      # (4, 14, 14)
    r = np.random.default_rng(7)
    det = [(r.uniform(0.2, 0.8, (4, 4)).astype(np.float32),
            np.array([3.0, 2.0, 1.5, -4.0], np.float32) + t,
            holes + r.normal(0, 0.1, holes.shape).astype(np.float32))
           for t in range(2)]
    cfg = PM.MaskletConfig(max_objects=4, max_dets=4, fill_hole_area=16,
                           hotstart_delay=0)
    skix_cfg = dataclasses.replace(SM.MaskletConfig(), **dataclasses.asdict(
        cfg))
    core = jax.jit(SM._masklet_frame_core.__wrapped__,
                   static_argnums=(0, 1, 2))
    state, banks = SM.init_masklet_state(skix_cfg), SkixBank(
        mem=jnp.zeros((4, 3, 14, 14, 48)), valid=jnp.zeros((4, 3), bool),
        ring_pos=jnp.ones((4,), jnp.int32))
    p_state = PM.init_masklet_state(cfg)
    p_banks = PM.init_memory(3, 14, 14, 48, 4)
    compiled = None
    for t in range(2):
        args = (trk_vars, jnp.asarray(frames[t:t + 1]),
                *(jnp.asarray(x) for x in det[t]), state, banks)
        if compiled is None:
            compiled = core.lower(skix_trk, skix_cfg, True, *args).compile(
                compiler_options=_CHEAP)
        state, banks, want = compiled(*args)
        with torch.no_grad():
            p_state, p_banks, got = PM._masklet_frame_core(
                port, cfg, True, torch.as_tensor(frames[t:t + 1]),
                *(torch.as_tensor(x) for x in det[t]), p_state, p_banks)
        for name in ("active", "obj_id", "spawn", "removed", "matched"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]), name)
        for name in ("out_mask_logits", "mem_mask_logits", "trk_scores"):
            close_scaled(got[name].numpy(), np.asarray(want[name]), 1e-4)
        close_scaled(p_banks.mem.numpy(), np.asarray(banks.mem), 1e-4)
        np.testing.assert_array_equal(p_banks.valid.numpy(),
                                      np.asarray(banks.valid))
    assert bool(p_state.active.any())                # a tracked frame ran
