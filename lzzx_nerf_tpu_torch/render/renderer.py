"""The serving frame: block windows -> prepass -> compaction -> block march
-> staged field eval + composite -> block scatter + background (port of
render_rays_compact_blocks and the torso pass of
lzzx_nerf_tpu/render/renderer.py), its per-ray fallback
render_rays_compact (per-ray windows and the per-ray exact march: odd
frame sides, infer_block 1); and the training renders: render_rays (the
full-path march, training and eval, and the serving path at cascade > 1),
render_rays_train_compact (window-compacted rays, optionally through the
staged training composite) and run_torso (the dense torso pass).

The JAX package scatters with mode="drop" to sentinel indices; here every
such scatter writes to one extra discarded row instead, so an out-of-range
index can neither raise nor write out of bounds.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..ops.composite import (composite_rays, cumprod_scan, cumprod_seq,
                             exclusive_cumprod)
from ..ops.march import MarchResult, march_rays_uniform
from ..ops.march2 import (BLOCK_VARIANTS, InferenceTables,
                          block_view, column_intervals, compact_rays,
                          default_window_candidates, march_rays_window,
                          march_rays_window_bitmask,
                          march_rays_window_bitmask_nb,
                          march_rays_window_bitmask_nb_block,
                          march_rays_window_bitmask_nb_block3,
                          prepass_block_hits, prepass_block_spans,
                          ray_windows)
from ..ops.ray import near_far_from_aabb
from ..models.nerf import FieldOutputs
from ..utils.clip import clip
from .state import OccupancyState, RenderSettings

# (pts [N, 3], dirs [N, 3]) -> (sigma [N], color [N, 3]) for one frame
FieldApply = Callable[[torch.Tensor, torch.Tensor], Any]


def field_outputs(apply: FieldApply) -> Callable[..., FieldOutputs]:
    """A serving field (sigma, color) as the FieldOutputs that render_rays
    and the full outputs of render_rays_compact composite, with zero
    ambient and uncertainty channels (the JAX package's fused apply at
    inference)."""
    def fn(pts, dirs):
        sigma, color = apply(pts, dirs)
        z = torch.zeros_like(sigma)
        return FieldOutputs(sigma, color, z, z, z)
    return fn


def effective_infer_stage2_budget(budget: int, stage2_budget: int) -> int:
    """The stage-2 slot count the staged eval uses (0 selects the
    default)."""
    return stage2_budget or max(1024, budget // 4 // 1024 * 1024)


def effective_train_stage2_budget(budget: int, stage2_budget: int) -> int:
    """The stage-2 slot count the staged training composite uses (0
    selects the default): what a step's n_stage2 is measured against."""
    return stage2_budget or max(1024, budget // 2 // 1024 * 1024)


def _repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x.repeat_interleave(k, dim=0) as a broadcast copy: no output-size
    computation, so it records into a CUDA graph."""
    return x.unsqueeze(1).expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


def _scatter_add_rows(dst: torch.Tensor, idx: torch.Tensor,
                      valid: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst[idx[i]] += src[i] where valid[i]; invalid rows go to a
    discarded extra row (the JAX scatter's mode="drop")."""
    n = dst.shape[0]
    tgt = torch.where(valid, idx, torch.full_like(idx, n))
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    ext.index_add_(0, tgt, src)
    return ext[:n]


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx[i]] = src[i] where valid[i], out of place (the JAX
    .at[].set(mode="drop")): invalid rows write one extra row that is
    sliced off, so their values, duplicates included, get no gradient."""
    n = dst.shape[0]
    tgt = torch.where(valid, idx, torch.full_like(idx, n))
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    return ext.index_copy(0, tgt, src)[:n]


def _staged_eval_composite(field_apply: FieldApply, settings: RenderSettings,
                           m, rd: torch.Tensor, B: int, S: int,
                           stage_split: int, stage2_budget: int,
                           full: bool = False, sample_budget: int = 0):
    """Two-stage field eval with exact early termination: samples
    [0, split) for all B rays, then [split, S) only for rays still
    transmissive (T >= T_thresh), compacted into `stage2_budget` slots;
    survivors beyond the slots end at the split. Returns (image_premult
    [B, 3], weights_sum [B], n_stage2, n_spts).

    sample_budget > 0: stage-1 sample compaction. Only the marched
    samples of the first split (the march mask) reach the field eval,
    compacted into sample_budget slots, and the results scatter back to
    their lattice slots; a masked-off sample adds nothing to the composite
    either way, so this is exact while the marched samples fit. Samples
    beyond the slots compose as empty space; n_spts reports the demand
    (None without compaction).

    full=True is the training twin (the JAX package's
    _staged_train_eval_composite): field_apply returns FieldOutputs, and
    the result is (image_premult, depth, weights_sum, ambient_aud,
    ambient_eye, uncertainty, n_stage2), the sums composite_rays makes.
    When every survivor has a slot it is gradient-exact as well: a sample
    past T < T_thresh adds nothing to any output, so its gradient is 0
    and its field eval can be skipped. The transmittance products
    associate as the JAX package's (cumprod_scan when the sigmas carry a
    gradient, cumprod_seq otherwise)."""
    S1, S2 = stage_split, S - stage_split
    thr = settings.T_thresh
    if full and sample_budget:
        raise ValueError("sample compaction is a serving eval (full=False)")

    def stage(out, n, s, deltas, mask, ts, T0=None):
        sigma, color = (out.sigma, out.color) if full else out
        sig = (sigma * settings.density_scale).reshape(n, s)
        alpha = (1.0 - torch.exp(-sig * deltas)) * mask
        P = (cumprod_scan if sig.requires_grad else cumprod_seq)(1.0 - alpha)
        T = torch.cat([torch.ones_like(P[:, :1]), P[:, :-1]], dim=-1)
        if T0 is not None:
            T = T0[:, None] * T
        proc = (T >= thr) & mask
        w = alpha * T * proc
        sums = [torch.einsum("ns,nsc->nc", w, color.reshape(n, s, 3)),
                w.sum(dim=-1)]
        if full:
            sums = [sums[0], torch.sum(w * ts, dim=-1), sums[1],
                    torch.sum(out.ambient_aud.abs().reshape(n, s) * proc,
                              dim=-1),
                    torch.sum(out.ambient_eye.abs().reshape(n, s) * proc,
                              dim=-1),
                    torch.sum(w * out.uncertainty.reshape(n, s), dim=-1)]
        # the inclusive product's last column: T after the stage
        return sums, P[:, -1]

    pts1 = m.xyzs[:, :S1].reshape(B * S1, 3)
    n_spts = None
    if sample_budget > 0:
        cp = compact_rays(m.mask[:, :S1].reshape(B * S1), sample_budget)
        n_spts = cp.n_active
        src = cp.ray_idx                                  # flat sample index
        sig_c, rgb_c = field_apply(pts1.index_select(0, src),
                                   rd.index_select(0, src // S1))
        out1 = (_set_rows(sig_c.new_zeros(B * S1), src, cp.slot_valid,
                          sig_c),
                _set_rows(rgb_c.new_zeros((B * S1, 3)), src, cp.slot_valid,
                          rgb_c))
    else:
        out1 = field_apply(pts1, _repeat_rows(rd, S1))
    sums, T_end = stage(out1, B, S1, m.deltas[:, :S1], m.mask[:, :S1],
                        m.ts[:, :S1] if full else None)
    zero = torch.zeros((), dtype=torch.int64, device=T_end.device)
    tail = () if full else (n_spts,)
    if S2 == 0:
        # the split clamped to S: stage 2 is empty (no survivor)
        return (*sums, zero, *tail)
    surv = (T_end >= thr) & m.mask[:, S1:].any(dim=-1)
    cs2 = compact_rays(surv, stage2_budget)
    idx2 = cs2.ray_idx

    def take(a):
        return a[:, S1:].index_select(0, idx2)

    T0 = T_end.index_select(0, idx2) * cs2.slot_valid
    out2 = field_apply(take(m.xyzs).reshape(stage2_budget * S2, 3),
                       _repeat_rows(rd.index_select(0, idx2), S2))
    sums2, _ = stage(out2, stage2_budget, S2, take(m.deltas),
                     take(m.mask) & cs2.slot_valid[:, None],
                     take(m.ts) if full else None, T0)
    return (*(_scatter_add_rows(a, idx2, cs2.slot_valid, b)
              for a, b in zip(sums, sums2)), cs2.n_active, *tail)


def _single_pass_composite(field_apply: FieldApply, settings: RenderSettings,
                           m, rd: torch.Tensor, B: int, S: int):
    """One field eval of all B*S samples and composite_rays' image and
    weight sum (the serving composite with stage_split=0). Returns
    (image_premult [B, 3], weights_sum [B])."""
    sigma, color = field_apply(m.xyzs.reshape(B * S, 3), _repeat_rows(rd, S))
    sig = (sigma * settings.density_scale).reshape(B, S)
    alpha = (1.0 - torch.exp(-sig * m.deltas)) * m.mask
    T = exclusive_cumprod(1.0 - alpha)
    w = alpha * T * ((T >= settings.T_thresh) & m.mask)
    return torch.einsum("ns,nsc->nc", w, color.reshape(B, S, 3)), w.sum(-1)


def _aabb(settings: RenderSettings, aabb, device) -> torch.Tensor:
    if aabb is not None:
        return aabb
    return torch.tensor(settings.aabb, dtype=torch.float32, device=device)


def _composite_outputs(out, m: MarchResult, B: int, S: int,
                       settings: RenderSettings):
    sigmas = (out.sigma * settings.density_scale).reshape(B, S)
    # the composite takes |amb| of the [N, 1] channels, i.e. the values
    return composite_rays(
        sigmas, out.color.reshape(B, S, 3),
        out.ambient_aud.abs().reshape(B, S),
        out.ambient_eye.abs().reshape(B, S),
        out.uncertainty.reshape(B, S), m.deltas, m.ts, m.mask,
        T_thresh=settings.T_thresh)


def render_rays(field_fn: Callable, settings: RenderSettings,
                state: OccupancyState, rays_o: torch.Tensor,
                rays_d: torch.Tensor, bg_color: torch.Tensor,
                noise: Optional[torch.Tensor] = None, training: bool = False,
                aabb: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The full-path render: march_rays_uniform over every ray (first S
    occupied lattice points of num_cand), one field eval of all N*S
    samples, composite, background.

    field_fn(pts [M, 3], dirs [M, 3]) -> models.FieldOutputs. noise [N] in
    [0, 1): the training lattice jitter. Returns image [N, 3], depth,
    weights_sum, ambient_aud, ambient_eye, uncertainty [N], and with
    training=True the sample set (pts, dirs, mask) for the jitter
    regulariser."""
    N = rays_o.shape[0]
    S = settings.max_steps
    # the lattice carries no gradient to the rays (train_camera's) through
    # its near bound, as in the JAX package
    nears, fars = (t.detach() for t in near_far_from_aabb(
        rays_o, rays_d, _aabb(settings, aabb, rays_o.device),
        settings.min_near))
    m = march_rays_uniform(rays_o, rays_d, nears, fars, state.occ,
                           settings.bound, settings.dt, settings.num_cand,
                           S, noise=noise)
    pts = m.xyzs.reshape(N * S, 3)
    dirs = _repeat_rows(rays_d, S)
    comp = _composite_outputs(field_fn(pts, dirs), m, N, S, settings)
    image = clip(comp.image + (1.0 - comp.weights_sum)[:, None] * bg_color,
                 0.0, 1.0)
    depth = clip(comp.depth - nears, 0.0) / clip(fars - nears, 1e-6)
    res: Dict[str, Any] = {
        "image": image, "depth": depth, "weights_sum": comp.weights_sum,
        "ambient_aud": comp.amb_aud_sum, "ambient_eye": comp.amb_eye_sum,
        "uncertainty": comp.uncertainty_sum}
    if training:
        res["rays"] = (pts, dirs, m.mask.reshape(-1))
    return res


def render_rays_train_compact(
        field_fn: Callable, settings: RenderSettings, state: OccupancyState,
        rays_o: torch.Tensor, rays_d: torch.Tensor, bg_color: torch.Tensor,
        budget: int, noise: Optional[torch.Tensor] = None,
        window_candidates: Optional[int] = None, stage_split: int = 0,
        stage2_budget: int = 0, aabb: Optional[torch.Tensor] = None
) -> Dict[str, Any]:
    """render_rays(training=True) for every ray that gets a slot, at a
    fraction of the work: rays whose windows (ray_windows over the
    occupancy's column intervals) are empty render background without a
    field eval, the active ones are compacted into `budget` slots and
    marched over their windows on the same noisy lattice and occupancy
    test as the full march (march_rays_window).

    Active rays beyond the budget render as background and get loss weight
    0; the slotted active rays are upweighted by n_active / n_slotted so
    the loss stays an unbiased estimate of the full batch's (`ray_weight`,
    which sums to N). n_active reports the demand.

    0 < stage_split < S: the staged training composite
    (_staged_eval_composite(full=True)): samples [0, split) for every
    slotted ray, [split, S) only for rays still transmissive at the split,
    compacted into effective_train_stage2_budget(budget, stage2_budget)
    slots; survivors beyond them end at the split (n_stage2 reports the
    demand). Gradient-exact whenever the survivors fit."""
    N = rays_o.shape[0]
    S = settings.max_steps
    K2 = window_candidates or settings.num_cand + 2
    nears, fars = (t.detach() for t in near_far_from_aabb(
        rays_o, rays_d, _aabb(settings, aabb, rays_o.device),
        settings.min_near))
    z_lo, z_hi = column_intervals(state.occ, settings.bound)
    win = ray_windows(rays_o, rays_d, nears, fars, z_lo, z_hi,
                      settings.bound, settings.dt)
    cs = compact_rays(win.active, budget)
    slotted = win.active & (torch.cumsum(win.active.to(torch.int64), 0)
                            <= budget)
    n_slot = torch.clamp(cs.n_active, max=budget).to(torch.float32)
    over_w = cs.n_active.to(torch.float32) / torch.clamp(n_slot, min=1.0)
    ray_weight = torch.where(win.active,
                             torch.where(slotted, over_w, 0.0), 1.0)

    cols = [rays_o, rays_d, win.t_start[:, None], win.t_end[:, None],
            nears[:, None], fars[:, None], bg_color]
    if noise is not None:
        cols.append(noise[:, None])
    rows = torch.cat(cols, dim=-1).index_select(0, cs.ray_idx)
    ro, rd = rows[:, 0:3], rows[:, 3:6]
    nears_c, fars_c = rows[:, 8], rows[:, 9]
    bg_c = rows[:, 10:13]
    noise_c = rows[:, 13] if noise is not None else None
    m = march_rays_window(ro, rd, rows[:, 6], rows[:, 7], cs.slot_valid,
                          state.occ, settings.bound, settings.dt, K2, S,
                          noise=noise_c, nears=nears_c)

    pts = m.xyzs.reshape(budget * S, 3)
    dirs = _repeat_rows(rd, S)
    staged = 0 < stage_split < S
    if staged:
        (img_c, depth_raw, wsum_c, amb_aud_c, amb_eye_c, unc_c,
         n_stage2) = _staged_eval_composite(
            field_fn, settings, m, rd, budget, S, stage_split,
            effective_train_stage2_budget(budget, stage2_budget), full=True)
    else:
        comp = _composite_outputs(field_fn(pts, dirs), m, budget, S,
                                  settings)
        img_c, depth_raw, wsum_c = comp.image, comp.depth, comp.weights_sum
        amb_aud_c, amb_eye_c, unc_c = (comp.amb_aud_sum, comp.amb_eye_sum,
                                       comp.uncertainty_sum)
    image_c = clip(img_c + (1.0 - wsum_c)[:, None] * bg_c, 0.0, 1.0)
    depth_c = clip(depth_raw - nears_c, 0.0) / clip(fars_c - nears_c, 1e-6)

    def scat(vals, base=None):
        if base is None:
            base = vals.new_zeros((N,) + vals.shape[1:])
        return _set_rows(base, cs.ray_idx, cs.slot_valid, vals)

    res = {
        "image": scat(image_c, clip(bg_color, 0.0, 1.0)),
        "depth": scat(depth_c),
        "weights_sum": scat(wsum_c),
        "ambient_aud": scat(amb_aud_c),
        "ambient_eye": scat(amb_eye_c),
        "uncertainty": scat(unc_c),
        "rays": (pts, dirs, m.mask.reshape(-1)),
        "ray_weight": ray_weight,
        "n_active": cs.n_active,
    }
    if staged:
        res["n_stage2"] = n_stage2
    return res


def render_rays_compact(
    field_apply: Callable,
    settings: RenderSettings,
    rays_o: torch.Tensor,            # [N, 3]
    rays_d: torch.Tensor,            # [N, 3]
    bg_color: torch.Tensor,          # [N, 3]
    budget: int,
    tables: InferenceTables,
    window_candidates: Optional[int] = None,
    minimal: bool = False,
    stage_split: int = 0,
    stage2_budget: int = 0,
    aabb: Optional[torch.Tensor] = None,
    sample_budget: int = 0,
) -> Dict[str, Any]:
    """The per-ray compact render (cascade 1): per-ray windows over the
    column intervals, the first `budget` active rays compacted into
    slots, the per-ray exact neighbourhood march
    (march_rays_window_bitmask_nb over tables.col_nbmask), the field eval
    and composite, scattered back over the frame; active rays beyond the
    budget render as background (n_active reports the demand).

    minimal: image, weights_sum, n_active and n_winmax only, with
    field_apply(pts, dirs) -> (sigma, color); with stage_split > 0 (the
    split clamped to S) the staged eval (_staged_eval_composite, with
    n_stage2; sample_budget > 0 adds the stage-1 sample compaction and
    n_spts), else the single-pass composite. minimal=False: also depth,
    ambient_aud, ambient_eye, uncertainty, with field_apply returning
    FieldOutputs (field_outputs wraps a serving field)."""
    if settings.cascade != 1:
        raise ValueError("the compact path supports cascade == 1 only")
    if tables.col_nbmask is None:
        raise ValueError("render_rays_compact marches with tables.col_nbmask "
                         "(ensure_variant_tables(..., ('nb',)))")
    N = rays_o.shape[0]
    S = settings.max_steps
    dt = settings.dt
    K2 = window_candidates or default_window_candidates(
        settings.bound, settings.grid_size, dt)
    nears, fars = near_far_from_aabb(
        rays_o, rays_d, _aabb(settings, aabb, rays_o.device),
        settings.min_near)
    win = ray_windows(rays_o, rays_d, nears, fars, tables.z_lo, tables.z_hi,
                      settings.bound, dt)
    cs = compact_rays(win.active, budget)
    steps = torch.ceil((win.t_end - win.t_start) / dt)
    n_winmax = torch.where(win.active, steps,
                           torch.zeros_like(steps)).max().to(torch.int64) + 1

    cols = [rays_o, rays_d, win.t_start[:, None], win.t_end[:, None]]
    if not minimal:
        cols += [nears[:, None], fars[:, None], bg_color]
    rows = torch.cat(cols, dim=-1).index_select(0, cs.ray_idx)
    ro, rd = rows[:, 0:3], rows[:, 3:6]
    m = march_rays_window_bitmask_nb(ro, rd, rows[:, 6], rows[:, 7],
                                     cs.slot_valid, tables.col_nbmask,
                                     settings.bound, dt, K2, S)

    def scat(vals, base=None):
        if base is None:
            base = vals.new_zeros((N,) + vals.shape[1:])
        return _set_rows(base, cs.ray_idx, cs.slot_valid, vals)

    if minimal:
        out: Dict[str, Any] = {"n_active": cs.n_active, "n_winmax": n_winmax}
        if stage_split > 0:
            b2 = effective_infer_stage2_budget(budget, stage2_budget)
            image_c, wsum_c, out["n_stage2"], n_spts = \
                _staged_eval_composite(field_apply, settings, m, rd, budget,
                                       S, min(stage_split, S), b2,
                                       sample_budget=sample_budget)
            if n_spts is not None:
                out["n_spts"] = n_spts
        else:
            image_c, wsum_c = _single_pass_composite(field_apply, settings,
                                                     m, rd, budget, S)
        wsum = scat(wsum_c)
        out["image"] = torch.clamp(
            scat(image_c) + (1.0 - wsum)[:, None] * bg_color, 0.0, 1.0)
        out["weights_sum"] = wsum
        return out

    comp = _composite_outputs(
        field_apply(m.xyzs.reshape(budget * S, 3), _repeat_rows(rd, S)), m,
        budget, S, settings)
    nears_c, fars_c, bg_c = rows[:, 8], rows[:, 9], rows[:, 10:13]
    image_c = clip(comp.image + (1.0 - comp.weights_sum)[:, None] * bg_c,
                   0.0, 1.0)
    depth_c = clip(comp.depth - nears_c, 0.0) / clip(fars_c - nears_c, 1e-6)
    return {"image": scat(image_c, clip(bg_color, 0.0, 1.0)),
            "depth": scat(depth_c),
            "weights_sum": scat(comp.weights_sum),
            "ambient_aud": scat(comp.amb_aud_sum),
            "ambient_eye": scat(comp.amb_eye_sum),
            "uncertainty": scat(comp.uncertainty_sum),
            "n_active": cs.n_active, "n_winmax": n_winmax}


def render_rays_compact_blocks(
    field_apply: FieldApply,
    settings: RenderSettings,
    rays_o_origin: torch.Tensor,     # [3] camera origin (shared by all rays)
    rays_d: torch.Tensor,            # [H*W, 3] row-major unit dirs
    H: int,
    W: int,
    bg_color: torch.Tensor,          # [H*W, 3]
    budget: int,                     # in rays (multiple of 4)
    tables: InferenceTables,
    window_candidates: Optional[int] = None,
    stage_split: int = 8,
    stage2_budget: int = 0,
    march_group: int = 2,
    march_variant: str = "nb5wp",
    sample_budget: int = 0,
    eval_budget: int = 0,
    march_bucket: Optional[tuple] = None,
    aabb: Optional[torch.Tensor] = None,
    march_prepass: bool = True,
) -> Dict[str, Any]:
    """Serving fast path with 2x2-pixel-block window analysis, the
    occupancy prepass (march_prepass, with the group-2 march only: its
    envelope is the block-shared march's), compaction into the ray
    budget, the march of march_group:
    - 2: the block-shared exact march over tables.col_nb5wmask, in
      variant march_variant (nb5wp = the CUDA select kernel; nb5w and
      the JAX package's other variants of the same samples,
      ops/march2.BLOCK_VARIANTS, = its plain version);
    - 3: the block-lattice 3x3 march (tables.col_nbmask);
    - 1: the per-ray exact neighbourhood march (tables.col_nbmask);
    - negative: the dilated single-column march with group |march_group|
      (tables.col_bitmask);
    then the post-march eval re-compaction and the staged eval
    (stage_split > 0, clamped to S) or the single-pass composite
    (stage_split=0).

    march_bucket = (K2s, short_budget): the short/long bucket march (the
    group-2 march with the prepass only: its split comes from the prepass
    spans). Each block's window is tightened to its prepass span (a shift
    by whole candidate groups, so every sample keeps its lattice position
    in real arithmetic; in float32 a sample's depth can move by an ulp,
    as in the JAX package); blocks whose span needs at most K2s
    candidates march in a short bucket of short_budget rays at K2s, the
    rest (and shorts beyond short_budget, which spill) in a long bucket
    of budget - short_budget rays at K2.

    eval_budget (rays, < budget to take effect): after the march, only
    blocks with at least one sample go on to the field eval, compacted
    into eval_budget // 4 blocks; a block with no sample composes to
    background either way. sample_budget > 0 (with the staged eval): the
    stage-1 sample compaction (_staged_eval_composite).

    aabb: settings.aabb as a [6] float32 tensor on the rays' device, made
    here when not given (a caller that records the frame into a CUDA
    graph passes it: a host-to-device copy cannot run while a graph
    records).

    Returns image [H*W, 3], weights_sum, and the diagnostics n_active
    (admitted rays, may exceed the budget), n_winmax (largest candidate
    count an active block window needs), with the staged eval n_stage2,
    with a bucket n_short (short demand) and n_long (long-bucket rays,
    spilled shorts included), with the re-compaction n_real (rays of real
    blocks), with the sample compaction n_spts (marched stage-1 samples);
    and, in slot order, march_mask / march_ts (the marched samples as they
    reach the eval) with slot_block / slot_valid (each slot's block
    index)."""
    prepass = march_prepass and march_group == 2
    if march_bucket is not None and not prepass:
        raise ValueError("march_bucket requires march_prepass and the "
                         "group-2 march (its split comes from the prepass "
                         "spans)")
    if march_group == 2 and march_variant not in BLOCK_VARIANTS:
        raise ValueError(f"unknown nb-block select variant {march_variant!r}")
    if march_group == 0:
        raise ValueError("march group 0: use 1, 2, 3 or a negative dilated "
                         "group")
    if settings.cascade != 1:
        raise ValueError("the compact path supports cascade == 1 only")
    if H % 2 or W % 2 or budget % 4:
        raise ValueError("H, W must be even and budget a multiple of 4")
    dev = rays_d.device
    N = H * W
    NB = N // 4
    S = settings.max_steps
    dt = settings.dt
    K2 = window_candidates or default_window_candidates(
        settings.bound, settings.grid_size, dt)
    budget_b = budget // 4
    if aabb is None:
        aabb = torch.tensor(settings.aabb, dtype=torch.float32, device=dev)
    if march_bucket is not None:
        K2s, short_budget = march_bucket
        if not 0 < short_budget < budget or short_budget % 4:
            raise ValueError(
                f"march_bucket short budget {short_budget} must be a "
                f"multiple of 4 in (0, {budget})")
        if K2s < S:
            raise ValueError(
                f"march_bucket K2s ({K2s}) cannot be below max_steps ({S})")

    d_blocks, d_center = block_view(rays_d, H, W)
    o_center = rays_o_origin.expand(d_center.shape)
    nears_b, fars_b = near_far_from_aabb(o_center, d_center, aabb,
                                         settings.min_near)
    win = ray_windows(o_center, d_center, nears_b, fars_b, tables.z_lo,
                      tables.z_hi, settings.bound, dt, pad_steps=3.0)
    if march_bucket is not None:
        hit, g_first, g_last = prepass_block_spans(
            o_center, d_center, win.t_start, win.t_end, tables.col_dilwords,
            settings.bound, dt, K2)
        active = win.active & hit
    elif prepass:
        active = win.active & prepass_block_hits(
            o_center, d_center, win.t_start, win.t_end, tables.col_dilwords,
            settings.bound, dt, K2)
    else:
        active = win.active
    steps = torch.ceil((win.t_end - win.t_start) / dt)
    n_winmax = torch.where(win.active, steps,
                           torch.zeros_like(steps)).max().to(torch.int64) + 1

    # each block's window, tightened to its prepass span in the bucketed
    # march: groups before g_first / after g_last hold no occupied
    # candidate, and the shift is a whole number of groups
    t0_all, t1_all = win.t_start, win.t_end
    if march_bucket is not None:
        gf = g_first.to(torch.float32)
        gl = g_last.to(torch.float32)
        t0_all = win.t_start + (2.0 * dt) * gf
        t1_all = torch.minimum(win.t_end, win.t_start + (2.0 * gl + 2.0) * dt)
    cols = torch.cat([d_blocks.reshape(NB, 12), t0_all[:, None],
                      t1_all[:, None], d_center], dim=-1)

    def march_blocks(cs, nb: int, k2: int):
        """Gather one compacted set's block rows, re-anchor each ray's
        window on its own near-based dt lattice, march at k2 candidates."""
        rows = cols.index_select(0, cs.ray_idx)                 # [nb, 17]
        rd_ = rows[:, :12].reshape(nb * 4, 3)
        t0_blk = rows[:, 12]
        t0b = _repeat_rows(t0_blk, 4)
        t1b = _repeat_rows(rows[:, 13], 4)
        dc = rows[:, 14:17]
        ro = rays_o_origin.expand(rd_.shape)
        sv = _repeat_rows(cs.slot_valid, 4)
        nears_r, fars_r = near_far_from_aabb(ro, rd_, aabb, settings.min_near)
        t_start = torch.maximum(nears_r, t0b)
        k0 = torch.ceil(torch.clamp(t_start - nears_r, min=0.0) / dt - 1e-4)
        t_start = nears_r + k0 * dt
        t_end = torch.minimum(fars_r, t1b)
        if march_group == 3:
            return rd_, march_rays_window_bitmask_nb_block3(
                ro, rd_, nears_r, t_end, sv, t0_blk, dc, tables.col_nbmask,
                settings.bound, dt, k2, S)
        if march_group == 2:
            return rd_, march_rays_window_bitmask_nb_block(
                ro.contiguous(), rd_, t_start, t_end, sv, t0_blk, dc,
                tables.col_nb5wmask, settings.bound, dt, k2,
                S, variant=march_variant)
        if march_group == 1:
            return rd_, march_rays_window_bitmask_nb(
                ro, rd_, t_start, t_end, sv, tables.col_nbmask,
                settings.bound, dt, k2, S)
        return rd_, march_rays_window_bitmask(
            ro, rd_, t_start, t_end, sv, tables.col_bitmask, settings.bound,
            dt, k2, S, group=-march_group)

    diag: Dict[str, Any] = {}
    if march_bucket is not None:
        Bs_b = short_budget // 4
        Bl_b = budget_b - Bs_b
        span = 2 * (g_last - g_first + 1) + 2
        short = active & (span <= K2s)
        rank_s = torch.cumsum(short.to(torch.int64), dim=0)
        slotted_s = short & (rank_s <= Bs_b)
        long_ = (active & ~short) | (short & ~slotted_s)
        cs_s = compact_rays(slotted_s, Bs_b)
        cs_l = compact_rays(long_, Bl_b)
        rd_s, m_s = march_blocks(cs_s, Bs_b, K2s)
        rd_l, m_l = march_blocks(cs_l, Bl_b, K2)
        m = MarchResult(*(torch.cat([a, b]) for a, b in zip(m_s, m_l)))
        rd = torch.cat([rd_s, rd_l])
        blk_idx = torch.cat([cs_s.ray_idx, cs_l.ray_idx])
        blk_valid = torch.cat([cs_s.slot_valid, cs_l.slot_valid])
        n_active = (cs_s.n_active + cs_l.n_active) * 4
        diag["n_short"] = rank_s[-1] * 4
        diag["n_long"] = cs_l.n_active * 4
    else:
        cs = compact_rays(active, budget_b)
        rd, m = march_blocks(cs, budget_b, K2)
        blk_idx, blk_valid = cs.ray_idx, cs.slot_valid
        n_active = cs.n_active * 4

    # post-march re-compaction: only blocks with a sample reach the eval;
    # overflowing ones render as background and show in n_real
    if eval_budget and eval_budget // 4 < budget_b:
        eb = max(1, eval_budget // 4)
        realb = m.mask.reshape(budget_b, 4 * S).any(dim=1) & blk_valid
        csr = compact_rays(realb, eb)
        diag["n_real"] = csr.n_active * 4
        sel, keep = csr.ray_idx, csr.slot_valid

        def take_rows(a):
            return a.reshape((budget_b, 4) + a.shape[1:]).index_select(
                0, sel).reshape((eb * 4,) + a.shape[1:])

        kept = _repeat_rows(keep, 4)[:, None]
        m = MarchResult(xyzs=take_rows(m.xyzs), deltas=take_rows(m.deltas),
                        ts=take_rows(m.ts), mask=take_rows(m.mask) & kept)
        rd = take_rows(rd)
        blk_idx = blk_idx.index_select(0, sel)
        blk_valid = keep & blk_valid.index_select(0, sel)
        budget_b = eb

    B = budget_b * 4
    if stage_split > 0:
        # the stage-2 slots follow the ray budget, as in the JAX package
        b2 = effective_infer_stage2_budget(budget, stage2_budget)
        image_c, wsum_c, diag["n_stage2"], n_spts = _staged_eval_composite(
            field_apply, settings, m, rd, B, S, min(stage_split, S), b2,
            sample_budget=sample_budget)
        if n_spts is not None:
            diag["n_spts"] = n_spts
    else:
        image_c, wsum_c = _single_pass_composite(field_apply, settings, m,
                                                 rd, B, S)

    # scatter per block: 16-wide rows (4 rays x (rgb + wsum))
    payload = torch.cat([image_c.reshape(budget_b, 12),
                         wsum_c.reshape(budget_b, 4)], dim=-1)
    acc = _scatter_add_rows(torch.zeros((NB, 16), device=dev), blk_idx,
                            blk_valid, payload)
    img_acc = acc[:, :12].reshape(H // 2, W // 2, 2, 2, 3).permute(
        0, 2, 1, 3, 4).reshape(N, 3)
    wsum = acc[:, 12:16].reshape(H // 2, W // 2, 2, 2).permute(
        0, 2, 1, 3).reshape(N)
    image = torch.clamp(img_acc + (1.0 - wsum)[:, None] * bg_color, 0.0, 1.0)
    return {"image": image, "weights_sum": wsum, "n_active": n_active,
            "n_winmax": n_winmax, **diag,
            # the samples as they reach the eval, slot-ordered
            "march_mask": m.mask, "march_ts": m.ts,
            "slot_block": blk_idx, "slot_valid": blk_valid}


# ---- torso --------------------------------------------------------------

def _bilinear_sample_2d(grid: torch.Tensor, coords: torch.Tensor
                        ) -> torch.Tensor:
    """align_corners=True bilinear sample of grid [H, W] at coords [N, 2]
    in [-1, 1]; coords[:, 0] indexes width, coords[:, 1] height."""
    H, W = grid.shape
    x = (coords[:, 0] + 1.0) * 0.5 * (W - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 1).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0
    wy = y - y0
    v00, v01 = grid[y0, x0], grid[y0, x1]
    v10, v11 = grid[y1, x0], grid[y1, x1]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


class TorsoPlan(NamedTuple):
    """The frame-invariant set of pixels the torso can touch."""

    idx: torch.Tensor      # [M] pixel indices (padded slots hold N)
    coords: torch.Tensor   # [M, 2] their bg_coords
    n_pixels: int          # frame pixel count N


def build_torso_plan(settings: RenderSettings, state: OccupancyState,
                     bg_coords: torch.Tensor, pad_to: int = 1024
                     ) -> TorsoPlan:
    """Host-side, once per model load (the torso grid is static)."""
    dev = bg_coords.device
    thresh = min(float(settings.density_thresh_torso),
                 float(state.mean_density_torso))
    occupancy = _bilinear_sample_2d(state.density_grid_torso,
                                    bg_coords).cpu().numpy()
    N = bg_coords.shape[0]
    idx = np.nonzero(occupancy > thresh)[0]
    M = max(pad_to, (len(idx) + pad_to - 1) // pad_to * pad_to)
    idx_p = np.concatenate([idx.astype(np.int64),
                            np.full(M - len(idx), N, np.int64)])
    coords = torch.zeros((M, 2), dtype=torch.float32, device=dev)
    coords[:len(idx)] = bg_coords[torch.as_tensor(idx, device=dev)]
    return TorsoPlan(idx=torch.as_tensor(idx_p, device=dev), coords=coords,
                     n_pixels=N)


def run_torso_compact(torso_apply, plan: TorsoPlan, pose: torch.Tensor,
                      ind_code_torso: Optional[torch.Tensor],
                      bg_color: torch.Tensor) -> torch.Tensor:
    """Torso pass over the plan's pixels; returns the composited
    background. torso_apply(coords, pose, code) -> (alpha, color, dx)."""
    alpha, color, _ = torso_apply(plan.coords, pose, ind_code_torso)
    N = plan.n_pixels
    bg_c = bg_color.index_select(0, torch.clamp(plan.idx, max=N - 1))
    blended = color * alpha + bg_c * (1.0 - alpha)
    # padded slots (idx == N) land on a discarded extra row
    ext = torch.cat([bg_color, bg_color.new_zeros((1, 3))])
    ext[plan.idx] = blended
    return ext[:N]


def run_torso(torso_apply: Callable, settings: RenderSettings,
              state: OccupancyState, bg_coords: torch.Tensor,
              pose: torch.Tensor, ind_code_torso: Optional[torch.Tensor],
              bg_color: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The torso pass of the training step and its eval: the torso field
    on every pixel of bg_coords [N, 2] (dense), masked to the cells of
    the torso grid above min(density_thresh_torso, mean_density_torso),
    composited over bg_color [N, 3]. torso_apply(coords, pose, code) ->
    (alpha [N, 1], color [N, 3], dx [N, 2]). "torso_color" is the
    composite (what the torso loss compares with the target), as in the
    JAX package."""
    thresh = torch.clamp(state.mean_density_torso,
                         max=settings.density_thresh_torso)
    occupancy = _bilinear_sample_2d(state.density_grid_torso, bg_coords)
    mask = (occupancy > thresh).to(torch.float32)[:, None]
    alpha, color, deform = torso_apply(bg_coords, pose, ind_code_torso)
    alpha = alpha * mask
    color = color * mask
    new_bg = color * alpha + bg_color * (1.0 - alpha)
    return {"bg_color": new_bg, "torso_alpha": alpha, "torso_color": new_bg,
            "deform": deform}
