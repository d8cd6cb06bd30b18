"""Serving session over a trained state (port of the load, plan, frame and
chunk loop of lzzx_nerf_tpu/serving/session.py for the production serving
point).

The session is built once from a trained-state file and a device: it loads
the EMA head and the torso, bakes the bf16 head tables and the f32 torso
table, builds the occupancy tables, and plans the march over the poses it
will render (the plan):
- K2 from the trajectory-measured windows;
- the ray budget from the prepass admission (the largest over the poses),
  grown so the long bucket holds its own demand (bench.py's sizing);
- the short/long bucket plan (measure_bucket_plan) and its short budget;
- the eval budget from the host-measured real rays (measure_real_blocks_
  host, the largest over the poses) x 1.25;
- the stage-2 budget from the ray budget (0.375 of it, in 1024-slot
  steps).

Each frame runs audio encode with the smooth-lips EMA (in its masked form,
so a chunk has no Python branch), rays, the torso pass,
render_rays_compact_blocks (nb5wp march with prepass, bucket march, eval
re-compaction, stage split 8) and the yuv420 packing. A chunk of frames
runs from static input buffers into static output buffers; on a GPU it is
captured once per plan as a CUDA graph and replayed (graph=False runs the
same chunk program eagerly: the path the graph is held to). Frames and
their counters are copied to pinned host buffers on a side stream and read
one chunk behind the dispatch.

The rebuild escapes of the JAX session: when a chunk's counters show that
a frame needed more than the plan holds (admitted rays > ray budget, a
window > K2, real rays > eval budget, long-bucket rays > long budget), the
session warns, streams the chunk as rendered and rebuilds the plan (and
captures the graph again) at the next chunk boundary.

Diverges from the JAX session: stage-2 survivors over the stage-2 budget
(rays still transmissive at the split, whose samples 8-15 the overflow
drops) are an escape too. The JAX session warns and keeps truncating them;
this session rebuilds with 1.25 x the observed survivors, rounded up to
the granule like the ray budget (capped at the ray budget, which holds
every survivor). At the production 0.375 the trained state's own poses
overflow it on every chunk.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import kernels
from ..models.nerf import NeRFField, TorsoField, make_fused_apply
from ..ops.march import num_candidates
from ..ops.march2 import (block_view, bucket_short_budget,
                          build_inference_tables, measure_bucket_plan,
                          measure_real_blocks_host, prepass_block_hits,
                          ray_windows, resolve_march_plan)
from ..ops.ray import near_far_from_aabb
from ..render.renderer import (build_torso_plan, render_rays_compact_blocks,
                               run_torso_compact)
from ..render.state import OccupancyState, RenderSettings
from ..utils.color import rgb_to_yuv420
from ..utils.device import resolve_device
from ..utils.rays import get_bg_coords, get_rays
from .state_io import load_trained_state, params_from_jax

SMOOTH_LIPS = 0.35   # EMA weight of the previous frame's audio code
# the production serving point (the JAX Config's infer_stage_split and
# infer_stage2_frac defaults)
STAGE_SPLIT = 8
STAGE2_FRAC = 0.375
# per-frame counters, in the order of a chunk's counter rows
COUNTERS = ("n_active", "n_winmax", "n_stage2", "n_real", "n_short",
            "n_long")
# chunks in flight: a chunk's frames are fetched when the next one has
# been dispatched
PIPELINE = 2


def _ceil_to(x: float, gran: int) -> int:
    return -(-int(x) // gran) * gran


class ServingSession:
    """Render yuv420 frames from a trained state on one device.

    march_bucket: True plans the short/long bucket march over the poses,
    False marches one bucket, a tuple (K2s, short_budget) fixes the plan.
    eval_recompact: the post-march eval re-compaction. budget, k2,
    eval_budget: start from these instead of the measured values (the
    escapes grow them as they would grow measured ones); stage2_budget:
    start from this stage-2 budget (at most the ray budget) instead of
    0.375 of the ray budget."""

    def __init__(self, state_path: str, device=None,
                 poses: Optional[np.ndarray] = None, res: Optional[int] = None,
                 chunk: int = 8, log=print,
                 march_bucket: Union[bool, tuple] = True,
                 eval_recompact: bool = True, budget: int = 0, k2: int = 0,
                 eval_budget: int = 0, stage2_budget: int = 0):
        t_build = time.perf_counter()
        self.device = dev = resolve_device(device)
        self.chunk = max(1, chunk)
        self.log = log
        st = load_trained_state(state_path)
        meta = st["meta"]
        self.meta = meta
        grid = int(meta["grid"])
        aabb = tuple(float(x) for x in meta["aabb"])
        dt = float(meta["dt"])
        self.settings = RenderSettings(
            bound=1.0, cascade=1, grid_size=grid, max_steps=16, dt=dt,
            num_cand=num_candidates(aabb, 0.05, dt), aabb=aabb)
        self.H = self.W = int(res or meta["res"])
        sc = self.H / float(meta["res"])
        self.intrinsics = tuple(float(v) * sc for v in meta["intrinsics"])
        self.poses = np.asarray(meta["poses"] if poses is None else poses,
                                np.float32).reshape(-1, 4, 4)
        self.poses_dev = torch.as_tensor(self.poses, device=dev)
        self.aabb = torch.tensor(aabb, dtype=torch.float32, device=dev)
        # the torso's inverse poses, on the host once (torch.linalg.inv
        # checks its result on the host, which a CUDA graph cannot hold)
        self.pose_inv_t = torch.linalg.inv(
            torch.as_tensor(self.poses).transpose(1, 2)).to(dev)

        occ = st["occ"]
        self.occ = OccupancyState(**{
            k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in occ.items()})

        head = st["head"]
        self.field = NeRFField(
            audio_in_dim=int(meta["audio_dim"]),
            ind_num=int(np.asarray(head["individual_codes"]).shape[0]))
        self.field.load_state_dict(params_from_jax(head))
        self.field.to(dev).eval()
        # bf16 head tables, baked in f32 and cast once (serving default)
        self.packed = self.field.bake_tables(torch.bfloat16)

        torso = st["torso"]
        self.torso = TorsoField(
            ind_dim_torso=8,
            ind_num=int(torso["individual_codes_torso"].shape[0]))
        self.torso.load_state_dict(params_from_jax(torso))
        self.torso.to(dev).eval()
        self.torso_packed = self.torso.bake_table(torch.float32)

        self.tables = build_inference_tables(self.occ.occ,
                                             self.settings.bound)
        frame = self.H * self.W
        self.bg = torch.ones((frame, 3), device=dev)
        bg_coords = get_bg_coords(self.H, self.W, device=dev)[0]
        self.torso_plan = build_torso_plan(self.settings, self.occ,
                                           bg_coords)

        # plan inputs: what was asked for, and what escapes have raised
        self.march_bucket = march_bucket
        self.eval_recompact = eval_recompact
        self._budget_override = budget
        self._k2_override = k2
        self._eval_override = eval_budget
        self._stage2_override = stage2_budget
        self._pending: Dict[str, int] = {}
        self._overflow_warned = self._long_warned = False
        self._measured: Dict[int, dict] = {}
        self.gran = 1024 if frame >= 65536 else 256
        self.frame_cap = max(self.gran, frame // self.gran * self.gran)
        self.k2_measured = 0 if k2 else resolve_march_plan(
            self.settings, self.tables.z_lo, self.tables.z_hi, self.poses,
            self.intrinsics, self.H, self.W, log=log)

        # the chunk program's static buffers: inputs (pose id, eye, valid
        # per frame; the audio windows), the smooth-lips carry, outputs
        C = self.chunk
        self._in_meta = torch.zeros((C, 3), device=dev)
        self._in_aud = torch.zeros((C, 8, 16, int(meta["audio_dim"])),
                                   device=dev)
        self._prev_enc = torch.zeros((1, self.field.audio_dim), device=dev)
        self._has_prev = torch.zeros((), device=dev)
        self._out_yuv = torch.zeros((C, frame * 3 // 2), dtype=torch.uint8,
                                    device=dev)
        self._out_cnt = torch.zeros((C, len(COUNTERS)), dtype=torch.int64,
                                    device=dev)
        pin = dev.type == "cuda"
        self._host_meta = [torch.zeros((C, 3), pin_memory=pin)
                           for _ in range(PIPELINE)]
        self._host_yuv = [torch.zeros((C, frame * 3 // 2), dtype=torch.uint8,
                                      pin_memory=pin)
                          for _ in range(PIPELINE)]
        self._host_cnt = [torch.zeros((C, len(COUNTERS)), dtype=torch.int64,
                                      pin_memory=pin)
                          for _ in range(PIPELINE)]
        self._copy_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                             else None)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[str, int] = {}
        self.captures = 0
        self._build_plan(t_build)

    # ---- plan ------------------------------------------------------------

    def _pose_windows(self, i: int):
        """Pose i's block view and block windows (the renderer's own)."""
        s = self.settings
        rays = get_rays(self.poses_dev[i:i + 1], self.intrinsics, self.H,
                        self.W)
        db, dc = block_view(rays["rays_d"][0], self.H, self.W)
        origin = rays["rays_o"][0, 0]
        oc = origin.expand(dc.shape)
        nb, fb = near_far_from_aabb(oc, dc, self.aabb, s.min_near)
        win = ray_windows(oc, dc, nb, fb, self.tables.z_lo, self.tables.z_hi,
                          s.bound, s.dt, pad_steps=3.0)
        return origin, db, oc, dc, win

    def _measure(self, k2: int) -> dict:
        """The plan's measurements at one K2, over the session's poses:
        the largest prepass admission, the bucket plan, the largest
        host-measured real-ray count."""
        got = self._measured.get(k2)
        if got is not None:
            return got
        s = self.settings
        n_adm = 0
        real_args = []
        for i in range(len(self.poses)):
            origin, db, oc, dc, win = self._pose_windows(i)
            hit = prepass_block_hits(oc, dc, win.t_start, win.t_end,
                                     self.tables.col_dilwords, s.bound,
                                     s.dt, k2)
            n_adm = max(n_adm, int((hit & win.active).sum()) * 4)
            if self.eval_recompact:
                real_args.append(tuple(t.cpu().numpy() for t in (
                    origin, db, win.t_start, win.t_end, win.active)))
        k2s = n_short = n_long = 0
        if self.march_bucket is True:
            k2s, n_short, n_long, _ = measure_bucket_plan(
                s, self.tables.z_lo, self.tables.z_hi,
                self.tables.col_dilwords, self.poses, self.intrinsics,
                self.H, self.W, k2, log=self.log)
        n_real = 0
        if real_args:
            occ3 = self.occ.occ[0].cpu().numpy()

            def real(a):
                o, db, t0, t1, act = a
                return 4 * measure_real_blocks_host(
                    occ3, s.aabb, s.min_near, o, db, t0, t1, act, s.bound,
                    s.dt, k2, chunk=4096)

            # numpy releases the GIL in its array loops: one pose a thread
            with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
                n_real = max(ex.map(real, real_args))
        got = self._measured[k2] = dict(n_adm=n_adm, k2s=k2s,
                                        n_short=n_short, n_long=n_long,
                                        n_real=n_real)
        return got

    def _build_plan(self, t0: float) -> None:
        """Size K2, the budgets and the bucket plan (at build, and again
        at a rebuild); the next chunk captures a new graph."""
        gran, cap = self.gran, self.frame_cap
        self.k2 = k2 = self._k2_override or self.k2_measured
        m = self._measure(k2)
        budget = self._budget_override or min(
            cap, max(gran, _ceil_to(m["n_adm"] + 256, gran)))
        bucket = None
        if isinstance(self.march_bucket, tuple):
            bucket = tuple(self.march_bucket)
        elif self.march_bucket and m["k2s"]:
            if not self._budget_override:
                # grow the total so the long bucket holds its own demand
                need = (bucket_short_budget(m["n_short"], budget, gran)
                        + max(gran, _ceil_to(m["n_long"] + 256, gran)))
                budget = max(budget, min(cap, need))
            bs = bucket_short_budget(m["n_short"], budget, gran)
            if bs:
                bucket = (m["k2s"], bs)
        eval_budget = 0
        if self.eval_recompact:
            eval_budget = min(budget, self._eval_override or max(
                gran, _ceil_to(m["n_real"] * 1.25, gran)))
        self.budget = budget
        self.bucket = bucket
        self.long_budget = budget - bucket[1] if bucket else 0
        self.eval_budget = eval_budget
        self.stage2_budget = (
            min(self._stage2_override, budget) if self._stage2_override
            else max(1024, int(budget * STAGE2_FRAC) // 1024 * 1024))
        self._graph = None
        self.build_seconds = time.perf_counter() - t0
        self.log(
            f"plan: K2={k2} K2s={bucket[0] if bucket else 0} "
            f"budget={budget} short_budget={bucket[1] if bucket else 0} "
            f"long_budget={self.long_budget} eval_budget={eval_budget} "
            f"stage2_budget={self.stage2_budget} (prepass admits up to "
            f"{m['n_adm']} rays, host-measured real rays up to "
            f"{m['n_real']}, over {len(self.poses)} poses; "
            f"{self.build_seconds:.1f} s)")

    # ---- the frame program ------------------------------------------------

    def reset_audio(self) -> None:
        """Forget the smooth-lips carry (a new audio stream)."""
        self._has_prev.zero_()
        self._prev_enc.zero_()

    @torch.no_grad()
    def encode_audio(self, auds: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Audio encode + one smooth-lips EMA step, in the JAX session's
        masked form: the carry advances only where valid > 0 (default 1)."""
        enc_new = self.field.encode_audio(auds)
        enc = torch.where(self._has_prev > 0,
                          SMOOTH_LIPS * self._prev_enc
                          + (1 - SMOOTH_LIPS) * enc_new, enc_new)
        if valid is None:
            valid = torch.ones((), device=self.device)
        self._prev_enc.copy_(torch.where(valid > 0, enc, self._prev_enc))
        self._has_prev.copy_(torch.maximum(self._has_prev, valid))
        return enc

    @torch.no_grad()
    def render_frame(self, pose_id, enc_a: torch.Tensor, eye: torch.Tensor,
                     use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        """One frame of session pose `pose_id` (an int or a [1] int64
        device tensor) -> {"yuv": [H*W*3//2] uint8, "image", "march_mask"
        (the samples that reach the eval, slot-ordered), and the counters
        of COUNTERS that the plan reports} (device tensors, not
        synchronised)."""
        H, W = self.H, self.W
        if isinstance(pose_id, int):
            pose_id = torch.tensor([pose_id], device=self.device)
        pose = self.poses_dev.index_select(0, pose_id)[0]
        inv_t = self.pose_inv_t.index_select(0, pose_id)[0]
        rays = get_rays(pose[None], self.intrinsics, H, W)
        origin = rays["rays_o"][0, 0]
        rays_d = rays["rays_d"][0]
        apply = make_fused_apply(self.field, self.packed, enc_a,
                                 self.field.individual_codes[0], eye,
                                 use_kernel=use_kernels)

        def torso_apply(coords, p, code):
            return self.torso(coords, p, code, self.torso_packed, inv_t)

        frame_bg = run_torso_compact(
            torso_apply, self.torso_plan, pose,
            self.torso.individual_codes_torso[0], self.bg)
        out = render_rays_compact_blocks(
            apply, self.settings, origin, rays_d, H, W, frame_bg,
            budget=self.budget, tables=self.tables,
            window_candidates=self.k2, stage_split=STAGE_SPLIT,
            stage2_budget=self.stage2_budget,
            march_variant="nb5wp" if use_kernels else "nb5w",
            eval_budget=self.eval_budget, march_bucket=self.bucket,
            aabb=self.aabb)
        img = torch.clamp(out["image"].reshape(H, W, 3), 0.0, 1.0)
        return {"yuv": rgb_to_yuv420(img), "image": img,
                "march_mask": out["march_mask"],
                **{k: out[k] for k in COUNTERS if k in out}}

    def _chunk_program(self, frames: int) -> None:
        """The first `frames` frames of the chunk, static inputs -> static
        outputs (what a CUDA graph records)."""
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        for j in range(frames):
            enc = self.encode_audio(self._in_aud[j], self._in_meta[j, 2])
            out = self.render_frame(self._in_meta[j, :1].long(), enc,
                                    self._in_meta[j, 1:2])
            self._out_yuv[j].copy_(out["yuv"])
            self._out_cnt[j].copy_(torch.stack(
                [out.get(k, zero) for k in COUNTERS]))

    def _capture(self) -> None:
        """Capture the chunk program as a CUDA graph for the current plan.
        One eager frame first warms up what initialises lazily (libraries,
        kernel attributes, cached constants); the carry it advances is put
        back. Launches recorded in the capture are counted at each
        replay, not at the capture."""
        saved = self._prev_enc.clone(), self._has_prev.clone()
        self._chunk_program(1)
        self._prev_enc.copy_(saved[0])
        self._has_prev.copy_(saved[1])
        torch.cuda.synchronize(self.device)
        self._graph = None
        before = dict(kernels.launches)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self._chunk_program(self.chunk)
        self._graph_launches = {k: kernels.launches[k] - before[k]
                                for k in before}
        kernels.launches.update(before)
        self._graph = g
        self.captures += 1

    # ---- the chunk loop ---------------------------------------------------

    def _dispatch(self, slot: int, use_graph: bool) -> None:
        if use_graph:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            for k, n in self._graph_launches.items():
                kernels.launches[k] += n
        else:
            self._chunk_program(self.chunk)
        if self._copy_stream is None:
            self._host_yuv[slot].copy_(self._out_yuv)
            self._host_cnt[slot].copy_(self._out_cnt)
            return
        main = torch.cuda.current_stream(self.device)
        cs = self._copy_stream
        cs.wait_stream(main)
        with torch.cuda.stream(cs):
            self._host_yuv[slot].copy_(self._out_yuv, non_blocking=True)
            self._host_cnt[slot].copy_(self._out_cnt, non_blocking=True)
        # the next chunk overwrites the outputs after this copy
        main.wait_stream(cs)

    def _consume(self, entry, frames: list, diags: Dict[str, list]) -> None:
        """Read one chunk's frames and counters, after its copy; check its
        counters against the plan it ran with (the rebuild escapes)."""
        base, count, slot, done, plan = entry
        if done is not None:
            done.synchronize()
        cnt = self._host_cnt[slot][:count].numpy().copy()
        yuv = self._host_yuv[slot][:count].numpy()
        frames.extend(yuv[j].copy() for j in range(count))
        for i, k in enumerate(COUNTERS):
            diags[k] += [int(v) for v in cnt[:, i]]
        self._check_chunk(base, count, cnt, plan)

    def _want(self, key: str, value: int) -> None:
        # max(): a later, smaller overflow never shrinks a pending rebuild
        self._pending[key] = max(self._pending.get(key, 0), value)

    def _check_chunk(self, base: int, count: int, cnt: np.ndarray,
                     plan: dict) -> None:
        gran, cap = self.gran, self.frame_cap
        c = {k: int(cnt[:, i].max()) for i, k in enumerate(COUNTERS)}
        last = base + count - 1
        if plan["bucket"] and c["n_long"] > plan["long_budget"]:
            # the short budget is fixed by the plan: the total grows
            want = min(cap, plan["bucket"][1] + max(
                gran, _ceil_to(c["n_long"] * 1.25, gran)))
            if want > self.budget:
                self.log(f"[WARN] frames {base}..{last}: {c['n_long']} "
                         f"long-bucket rays exceed the long budget "
                         f"{plan['long_budget']}; rebuilding with total "
                         f"budget {want} at the next chunk boundary")
                self._want("budget", want)
            elif not self._long_warned:
                self.log(f"[WARN] frames {base}..{last}: {c['n_long']} "
                         f"long-bucket rays exceed the long budget "
                         f"{plan['long_budget']} with the total budget at "
                         "the frame cap; overflow rendered as background")
                self._long_warned = True
        if c["n_winmax"] > plan["k2"]:
            want = c["n_winmax"] + 4
            want += want % 2
            if want > max(self.k2, self._pending.get("k2", 0)):
                self.log(f"[WARN] frames {base}..{last}: a window needs "
                         f"{c['n_winmax']} march candidates > "
                         f"K2={plan['k2']} (truncated rays lose far-side "
                         f"samples); rebuilding with K2={want} at the next "
                         "chunk boundary")
                self._pending["k2"] = want
            else:
                self.log(f"[WARN] frames {base}..{last}: {count} frame(s) "
                         f"streamed truncated (planned at K2={plan['k2']}, "
                         f"needed {c['n_winmax']}) before the K2 rebuild "
                         "takes effect")
        if c["n_stage2"] > plan["stage2_budget"]:
            # the plan caps it at the ray budget it is built with
            want = min(cap, max(gran, _ceil_to(c["n_stage2"] * 1.25, gran)))
            msg = (f"[WARN] frames {base}..{last}: {c['n_stage2']} "
                   f"stage-2 survivors exceed the stage-2 budget "
                   f"{plan['stage2_budget']}; those rays truncate at the "
                   "split")
            if want > max(
                    self.stage2_budget, self._pending.get("stage2", 0)):
                self.log(f"{msg}; rebuilding with stage-2 budget {want} at "
                         "the next chunk boundary")
                self._want("stage2", want)
            else:
                self.log(msg)
        if plan["eval_budget"] and c["n_real"] > plan["eval_budget"]:
            want = min(self.budget,
                       max(gran, _ceil_to(c["n_real"] * 1.25, gran)))
            if want > self.eval_budget:
                self.log(f"[WARN] frames {base}..{last}: {c['n_real']} "
                         f"real-sample rays exceed eval budget "
                         f"{plan['eval_budget']}; rebuilding with {want} at "
                         "the next chunk boundary")
                self._want("eval", want)
        if c["n_active"] > self.budget and self.budget < cap:
            want = min(cap, max(gran, _ceil_to(c["n_active"] * 1.25, gran)))
            self.log(f"[WARN] frames {base}..{last}: {c['n_active']} "
                     f"active rays exceed budget {self.budget}; rebuilding "
                     f"with budget {want} at the next chunk boundary")
            self._want("budget", want)
        if (not self._overflow_warned and self.budget >= cap
                and c["n_active"] > self.budget):
            self.log(f"[WARN] frames {base}..{last}: {c['n_active']} "
                     f"active rays exceed the whole-frame budget "
                     f"{self.budget}; overflow rendered as background")
            self._overflow_warned = True

    def _rebuild_due(self) -> bool:
        p = self._pending
        return (p.get("budget", 0) > self.budget or p.get("k2", 0) > self.k2
                or p.get("eval", 0) > self.eval_budget
                or p.get("stage2", 0) > self.stage2_budget)

    def rebuild_pending(self) -> bool:
        """True when the last chunk rendered asks for a rebuild, which the
        next render() makes before its first chunk."""
        return bool(self._pending) and self._rebuild_due()

    def _rebuild(self) -> None:
        t0 = time.perf_counter()
        p = self._pending
        if p.get("budget", 0) > self.budget:
            self._budget_override = p["budget"]
        if p.get("k2", 0) > self.k2:
            self._k2_override = p["k2"]
        if p.get("eval", 0) > self.eval_budget:
            self._eval_override = p["eval"]
        if p.get("stage2", 0) > self.stage2_budget:
            self._stage2_override = p["stage2"]
        self._pending = {}
        self.log("rebuild at a chunk boundary")
        self._build_plan(t0)

    @torch.no_grad()
    def render(self, auds: np.ndarray, eyes: Sequence[float],
               pose_ids: Optional[Sequence[int]] = None,
               graph: Optional[bool] = None) -> Dict[str, object]:
        """Render F frames: auds [F, 8, 16, audio_dim] (each frame's 8-frame
        feature window), eyes [F], pose_ids [F] into the session's poses
        (default: frame f uses pose f mod P). graph: run each chunk as
        its CUDA graph (the default on a GPU) or eagerly (the default, and
        the only way, on the CPU). Returns {"frames": list of yuv420
        uint8 arrays, a list per counter of COUNTERS (0 where the plan
        does not report it), "seconds": wall time until the last frame is
        on the host}."""
        dev = self.device
        use_graph = dev.type == "cuda" if graph is None else graph
        if use_graph and dev.type != "cuda":
            raise ValueError("CUDA-graph capture needs a CUDA device")
        F_ = len(auds)
        C = self.chunk
        if pose_ids is None:
            pose_ids = [f % len(self.poses) for f in range(F_)]
        auds_t = torch.as_tensor(np.asarray(auds, np.float32), device=dev)
        frames: List[np.ndarray] = []
        diags: Dict[str, list] = {k: [] for k in COUNTERS}
        queue: deque = deque()
        t0 = time.perf_counter()
        for n_chunk, base in enumerate(range(0, F_, C)):
            if self._pending and self._rebuild_due():
                while queue:
                    self._consume(queue.popleft(), frames, diags)
                if self._rebuild_due():
                    self._rebuild()
            self._pending = {}
            count = min(C, F_ - base)
            slot = n_chunk % PIPELINE
            meta = self._host_meta[slot]
            for j in range(C):
                f = base + min(j, count - 1)
                meta[j, 0] = int(pose_ids[f])
                meta[j, 1] = float(eyes[f])
                meta[j, 2] = 1.0 if j < count else 0.0
            self._in_meta.copy_(meta, non_blocking=True)
            self._in_aud[:count].copy_(auds_t[base:base + count])
            if count < C:   # the tail repeats its last frame, not carried
                self._in_aud[count:].copy_(
                    auds_t[base + count - 1].expand(C - count,
                                                    *auds_t.shape[1:]))
            self._dispatch(slot, use_graph)
            done = None
            if self._copy_stream is not None:
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            queue.append((base, count, slot, done, dict(
                k2=self.k2, bucket=self.bucket, long_budget=self.long_budget,
                eval_budget=self.eval_budget,
                stage2_budget=self.stage2_budget)))
            if len(queue) >= PIPELINE:
                self._consume(queue.popleft(), frames, diags)
        while queue:
            self._consume(queue.popleft(), frames, diags)
        return {"frames": frames, "seconds": time.perf_counter() - t0,
                **diags}
