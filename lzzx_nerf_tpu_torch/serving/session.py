"""Serving sessions of the port (lzzx_nerf_tpu/serving/session.py).

Two sessions run one chunk program (_Session):

- ServingSession, the port bench's: built from a trained-state file, it
  renders the state's poses (or given ones) over a white background,
  with a plan measured over those poses.
- InferenceSession, the JAX session's API: load_model(data_path,
  workspace) reads a dataset directory (poses, intrinsics, frame size,
  background, eye areas, audio) and the workspace's production_state.pkl;
  the plan comes from the Config as the JAX session's _compile_render
  builds it; set_audio_features, run(sink) and run_live(feature_stream,
  sink) stream frames into a FrameSink (serving/streaming.py).

What both share: the trained state on one device (the EMA head with its
bf16 tables, or a hash head, which has none; the torso with its f32 table
when the state has one, or a tiled torso; the occupancy tables), the
frame (audio encode with the smooth-lips EMA in its masked form, so a
chunk has no Python branch; rays; the torso pass
or the plain background; render_rays_compact_blocks: nb5wp march with
the prepass, the bucket march, the eval re-compaction, the staged eval;
yuv420p or rgb24 bytes), the chunk program (static input buffers to
static output buffers; on a GPU captured once per plan as a CUDA graph
and replayed), the chunk loop (inputs staged in pinned host buffers,
frames and counters copied back on a side stream and read one chunk
behind the dispatch, strictly in order), and the rebuild escapes of the
JAX session: when a chunk's counters show that a frame needed more than
the plan holds (admitted rays > ray budget, a window > K2, real rays >
eval budget, long-bucket rays > long budget), the session warns, streams
the chunk as rendered and rebuilds the plan (and captures the graph
again) at the next chunk boundary.

Diverges from the JAX session: stage-2 survivors over the stage-2 budget
(rays still transmissive at the split, whose samples after it the
overflow drops) are an escape too. The JAX session warns and keeps
truncating them; this session rebuilds with 1.25 x the observed
survivors, rounded up to the granule like the ray budget (capped at the
ray budget, which holds every survivor).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import kernels
from ..config import Config
from ..models.nerf import NeRFField, TorsoField, make_fused_apply
from ..ops.march import num_candidates
from ..ops.march2 import (block_view, bucket_short_budget,
                          build_inference_tables, ensure_variant_tables,
                          measure_bucket_plan, measure_real_blocks_host,
                          needed_variant_tables, prepass_block_hits,
                          ray_windows, resolve_march_plan)
from ..ops.ray import near_far_from_aabb
from ..render.renderer import (build_torso_plan, field_outputs, render_rays,
                               render_rays_compact,
                               render_rays_compact_blocks, run_torso_compact)
from ..render.state import OccupancyState, RenderSettings
from ..utils.color import rgb_to_yuv420
from ..utils.device import resolve_device
from ..utils.pose import camera_refinement
from ..utils.profiling import PhaseAccumulator
from ..utils.rays import get_bg_coords, get_rays
from .state_io import (head_encoder, load_trained_state,
                       load_workspace_state, params_from_jax, torso_encoder)
from .streaming import FrameSink, NullSink

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


class _Session:
    """A trained identity on one device and the chunk program that
    renders it. A subclass loads it (_load) and sizes the plan
    (_build_plan: k2, budget, bucket, long_budget, eval_budget,
    stage2_budget, from the overrides the escapes raise)."""

    stage_split = STAGE_SPLIT

    # ---- the identity ----------------------------------------------------

    # the frame's render path: "blocks" (render_rays_compact_blocks),
    # "compact" (render_rays_compact: odd frame sides, infer_block 1) or
    # "full" (render_rays: cascade > 1)
    path = "blocks"
    march_group = 2
    train_camera = False

    def _load(self, st: dict, device: torch.device, settings: RenderSettings,
              H: int, W: int, intrinsics, poses, bg: np.ndarray, chunk: int,
              att: int = 2, log=print,
              variants: tuple = ("nb5w", "dil")) -> None:
        """Put the state `st` (load_trained_state's dict) on `device` for
        H x W frames at `poses` [P, 4, 4] over the background `bg`
        [H, W, 3]: the head (EMA weights, bf16 tables of a dense head; a
        hash head has none), the torso when the state has one (f32 table
        of a dense torso; a tiled torso has none; the frame-invariant
        torso plan), the occupancy and its tables. Each field's encoder
        is the one its tree holds (state_io.head_encoder,
        torso_encoder)."""
        self.device = dev = device
        self.log = log
        self.settings = settings
        self.H, self.W = H, W
        self.intrinsics = tuple(float(v) for v in intrinsics)
        self.poses = np.asarray(poses, np.float32).reshape(-1, 4, 4)
        self.poses_dev = torch.as_tensor(self.poses, device=dev)
        self.aabb = torch.tensor(settings.aabb, dtype=torch.float32,
                                 device=dev)
        # the torso's inverse poses, on the host once (torch.linalg.inv
        # checks its result on the host, which a CUDA graph cannot hold)
        self.pose_inv_t = torch.linalg.inv(
            torch.as_tensor(self.poses).transpose(1, 2)).to(dev)
        self.occ = OccupancyState(**{
            k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in st["occ"].items()})

        head = st["head"]
        codes = head.get("individual_codes")
        cam = head.get("camera_dR")
        self.field = NeRFField(
            bound=settings.bound,
            audio_in_dim=int(st["meta"]["audio_dim"]), att=att,
            ind_dim=0 if codes is None else int(np.shape(codes)[1]),
            ind_num=1 if codes is None else int(np.shape(codes)[0]),
            camera_frames=0 if cam is None else int(np.shape(cam)[0]),
            encoder=head_encoder(head))
        self.field.load_state_dict(params_from_jax(head))
        self.field.to(dev).eval()
        self.ind_code = (None if codes is None
                         else self.field.individual_codes[0].detach())
        # bf16 head tables, baked in f32 and cast once (serving default;
        # {} for a hash head)
        self.packed = self.field.bake_tables(torch.bfloat16)

        frame = H * W
        self.bg = torch.as_tensor(
            np.asarray(bg, np.float32).reshape(frame, 3), device=dev)
        torso = st["torso"]
        self.torso = self.torso_packed = self.torso_plan = None
        if torso is not None:
            tcodes = np.asarray(torso["individual_codes_torso"])
            self.torso = TorsoField(torso_shrink=settings.torso_shrink,
                                    ind_dim_torso=tcodes.shape[1],
                                    ind_num=tcodes.shape[0],
                                    encoder=torso_encoder(torso))
            self.torso.load_state_dict(params_from_jax(torso))
            self.torso.to(dev).eval()
            self.torso_packed = self.torso.bake_table(torch.float32)
            self.torso_plan = build_torso_plan(
                settings, self.occ, get_bg_coords(H, W, device=dev)[0])
        self.tables = build_inference_tables(self.occ.occ, settings.bound,
                                             variants=variants)

        self.gran = 1024 if frame >= 65536 else 256
        self.frame_cap = max(self.gran, frame // self.gran * self.gran)
        self._pending: Dict[str, int] = {}
        self._overflow_warned = self._long_warned = False
        self.rebuilds = 0
        self.chunk = max(1, chunk)
        # the smooth-lips carry
        self._prev_enc = torch.zeros((1, self.field.audio_dim), device=dev)
        self._has_prev = torch.zeros((), device=dev)
        self._bufs_key = None
        self._copy_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                             else None)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_launches: Dict[str, int] = {}
        self.captures = 0

    def _buffers(self, fmt: str, aud_shape) -> None:
        """The chunk program's static buffers for the chunk size, the
        output format ("yuv420p" or "rgb24") and the shape of a frame's
        audio window: inputs (pose id, eye, valid per frame; the audio
        windows), outputs (frame bytes, counters), and their pinned host
        copies, one set per chunk in flight. A change drops the graph."""
        key = (self.chunk, fmt, tuple(aud_shape))
        if key == self._bufs_key:
            return
        C, dev = self.chunk, self.device
        frame = self.H * self.W
        nbytes = frame * 3 // 2 if fmt == "yuv420p" else frame * 3
        pin = dev.type == "cuda"

        def pair(shape, dtype=torch.float32):
            return (torch.zeros(shape, dtype=dtype, device=dev),
                    [torch.zeros(shape, dtype=dtype, pin_memory=pin)
                     for _ in range(PIPELINE)])

        self._in_meta, self._host_meta = pair((C, 3))
        self._in_aud, self._host_aud = pair((C, *aud_shape))
        self._out, self._host_out = pair((C, nbytes), torch.uint8)
        self._out_cnt, self._host_cnt = pair((C, len(COUNTERS)), torch.int64)
        self._fmt = fmt
        self._bufs_key = key
        self._graph = None

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
                     use_kernels: bool = True, fmt: str = "yuv420p"
                     ) -> Dict[str, torch.Tensor]:
        """One frame of session pose `pose_id` (an int or a [1] int64
        device tensor) -> {"yuv": [H*W*3//2] uint8 (fmt "yuv420p") or
        "rgb": [H*W*3] uint8 (fmt "rgb24", the clipped image x 255
        truncated, as the JAX session casts it), "image", "march_mask"
        (the samples that reach the eval, slot-ordered), and the counters
        of COUNTERS that the plan reports} (device tensors, not
        synchronised)."""
        H, W = self.H, self.W
        if isinstance(pose_id, int):
            pose_id = torch.tensor([pose_id], device=self.device)
        pose = self.poses_dev.index_select(0, pose_id)[0]
        rays = get_rays(pose[None], self.intrinsics, H, W)
        origin = rays["rays_o"][0, 0]
        rays_d = rays["rays_d"][0]
        if self.train_camera:
            # the learned per-frame pose refinement, as the train step
            # applies it
            dR, dT = camera_refinement(self.field.camera_dR.detach(),
                                       self.field.camera_dT.detach(),
                                       pose_id[0])
            origin = origin + dT
            rays_d = rays_d @ dR
        apply = make_fused_apply(self.field, self.packed, enc_a,
                                 self.ind_code, eye, use_kernel=use_kernels)
        frame_bg = self.bg
        if self.torso is not None:
            inv_t = self.pose_inv_t.index_select(0, pose_id)[0]

            def torso_apply(coords, p, code):
                return self.torso(coords, p, code, self.torso_packed, inv_t)

            frame_bg = run_torso_compact(
                torso_apply, self.torso_plan, pose,
                self.torso.individual_codes_torso[0], self.bg)
        if self.path == "blocks":
            out = render_rays_compact_blocks(
                apply, self.settings, origin, rays_d, H, W, frame_bg,
                budget=self.budget, tables=self.tables,
                window_candidates=self.k2, stage_split=self.stage_split,
                stage2_budget=self.stage2_budget,
                march_group=self.march_group,
                march_variant="nb5wp" if use_kernels else "nb5w",
                eval_budget=self.eval_budget, march_bucket=self.bucket,
                aabb=self.aabb)
        elif self.path == "compact":
            out = render_rays_compact(
                apply, self.settings, origin.expand(rays_d.shape), rays_d,
                frame_bg, budget=self.budget, tables=self.tables,
                window_candidates=self.k2, minimal=True,
                stage_split=self.stage_split,
                stage2_budget=self.stage2_budget, aabb=self.aabb)
        else:
            out = render_rays(field_outputs(apply), self.settings, self.occ,
                              origin.expand(rays_d.shape), rays_d, frame_bg,
                              aabb=self.aabb)
        img = torch.clamp(out["image"].reshape(H, W, 3), 0.0, 1.0)
        res = {"image": img, **{k: out[k] for k in COUNTERS if k in out}}
        if "march_mask" in out:
            res["march_mask"] = out["march_mask"]
        if fmt == "yuv420p":
            res["yuv"] = rgb_to_yuv420(img)
        else:
            res["rgb"] = (img * 255).to(torch.uint8).reshape(-1)
        return res

    def _chunk_program(self, frames: int) -> None:
        """The first `frames` frames of the chunk, static inputs -> static
        outputs (what a CUDA graph records)."""
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        key = "yuv" if self._fmt == "yuv420p" else "rgb"
        for j in range(frames):
            enc = self.encode_audio(self._in_aud[j], self._in_meta[j, 2])
            out = self.render_frame(self._in_meta[j, :1].long(), enc,
                                    self._in_meta[j, 1:2], fmt=self._fmt)
            self._out[j].copy_(out[key])
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
            self._host_out[slot].copy_(self._out)
            self._host_cnt[slot].copy_(self._out_cnt)
            return
        main = torch.cuda.current_stream(self.device)
        cs = self._copy_stream
        cs.wait_stream(main)
        with torch.cuda.stream(cs):
            self._host_out[slot].copy_(self._out, non_blocking=True)
            self._host_cnt[slot].copy_(self._out_cnt, non_blocking=True)
        # the next chunk overwrites the outputs after this copy
        main.wait_stream(cs)

    @torch.no_grad()
    def _stream(self, start: int, n: int, frame_inputs: Callable,
                emit: Callable, fmt: str, use_graph: bool,
                acc: Optional[PhaseAccumulator] = None) -> None:
        """Render frames [start, n) in chunks of self.chunk, the chunk
        lattice anchored at `start`. frame_inputs(i) -> (pose id, eye,
        audio window) of frame i. A tail chunk repeats its last frame in
        slots that render but do not advance the carry.
        emit(base, count, frames, counters) receives each chunk once its
        frames are on the host and its counters checked, strictly in
        order: frames [count, bytes] uint8 and counters [count,
        len(COUNTERS)], views of buffers the stream reuses (copy what is
        kept). acc: time the host phases, reported every 25 chunks."""
        if use_graph and self.device.type != "cuda":
            raise ValueError("CUDA-graph capture needs a CUDA device")
        ph = acc.phase if acc else (lambda name: nullcontext())
        C = self.chunk
        queue: deque = deque()
        for n_chunk, base in enumerate(range(start, n, C)):
            if self._pending and self._rebuild_due():
                while queue:
                    self._consume(queue.popleft(), emit)
                if self._rebuild_due():
                    self._rebuild()
            self._pending = {}
            count = min(C, n - base)
            slot = n_chunk % PIPELINE
            with ph("stack-inputs"):
                ins = [frame_inputs(base + min(j, count - 1))
                       for j in range(C)]
                self._buffers(fmt, np.shape(ins[0][2]))
                self._host_meta[slot].numpy()[:] = [
                    (float(p), float(e), 1.0 if j < count else 0.0)
                    for j, (p, e, _) in enumerate(ins)]
                self._host_aud[slot].numpy()[:] = np.stack(
                    [a for _, _, a in ins])
                self._in_meta.copy_(self._host_meta[slot], non_blocking=True)
                self._in_aud.copy_(self._host_aud[slot], non_blocking=True)
            with ph("dispatch"):
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
                with ph("fetch+sink"):
                    self._consume(queue.popleft(), emit)
            if acc and n_chunk and n_chunk % 25 == 0:
                self.log(f"[profile] frame {base}: {acc.report()}")
        while queue:
            with ph("fetch+sink"):
                self._consume(queue.popleft(), emit)

    def _consume(self, entry, emit: Callable) -> None:
        """Read one chunk's counters after its copy, check them against
        the plan it ran with (the rebuild escapes), emit its frames."""
        base, count, slot, done, plan = entry
        if done is not None:
            done.synchronize()
        cnt = self._host_cnt[slot][:count].numpy().copy()
        self._check_chunk(base, count, cnt, plan)
        emit(base, count, self._host_out[slot][:count].numpy(), cnt)

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
        next render makes before its first chunk."""
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
        self.rebuilds += 1
        self.log("rebuild at a chunk boundary")
        self._build_plan(t0)

    def _build_plan(self, t0: float) -> None:
        raise NotImplementedError

    def _plan_line(self, t0: float, detail: str) -> None:
        self._graph = None
        self.build_seconds = time.perf_counter() - t0
        b = self.bucket
        self.log(
            f"plan: K2={self.k2} K2s={b[0] if b else 0} "
            f"budget={self.budget} short_budget={b[1] if b else 0} "
            f"long_budget={self.long_budget} eval_budget={self.eval_budget} "
            f"stage2_budget={self.stage2_budget} ({detail}; "
            f"{self.build_seconds:.1f} s)")


class ServingSession(_Session):
    """Render yuv420 frames of a trained state's poses on one device (the
    port bench's session), over a white background.

    The plan is measured over the poses it will render:
    - K2 from the trajectory-measured windows;
    - the ray budget from the prepass admission (the largest over the
      poses), grown so the long bucket holds its own demand (bench.py's
      sizing);
    - the short/long bucket plan (measure_bucket_plan) and its short
      budget;
    - the eval budget from the host-measured real rays
      (measure_real_blocks_host, the largest over the poses) x 1.25;
    - the stage-2 budget from the ray budget (0.375 of it, in 1024-slot
      steps).

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
        st = load_trained_state(state_path)
        meta = self.meta = st["meta"]
        aabb = tuple(float(x) for x in meta["aabb"])
        dt = float(meta["dt"])
        settings = RenderSettings(
            bound=1.0, cascade=1, grid_size=int(meta["grid"]), max_steps=16,
            dt=dt, num_cand=num_candidates(aabb, 0.05, dt), aabb=aabb)
        H = W = int(res or meta["res"])
        sc = H / float(meta["res"])
        self._load(st, resolve_device(device), settings, H, W,
                   [float(v) * sc for v in meta["intrinsics"]],
                   meta["poses"] if poses is None else poses,
                   np.ones((H, W, 3), np.float32), chunk, log=log)

        # plan inputs: what was asked for, and what escapes have raised
        self.march_bucket = march_bucket
        self.eval_recompact = eval_recompact
        self._budget_override = budget
        self._k2_override = k2
        self._eval_override = eval_budget
        self._stage2_override = stage2_budget
        self._measured: Dict[int, dict] = {}
        self.k2_measured = 0
        if not k2:
            self.k2_measured, group, _ = resolve_march_plan(
                self.settings, self.tables.z_lo, self.tables.z_hi,
                self.poses, self.intrinsics, self.H, self.W, march_group=2,
                march_variant="nb5wp", measure="block", log=log)
            if group != 2:
                raise ValueError(
                    "these poses exceed the block march's drift envelope; "
                    "the bench session plans the group-2 block march only "
                    "(InferenceSession steps down to the per-ray march)")
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
        self._plan_line(t0, f"prepass admits up to {m['n_adm']} rays, "
                        f"host-measured real rays up to {m['n_real']}, over "
                        f"{len(self.poses)} poses")

    # ---- rendering ------------------------------------------------------

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
        use_graph = self.device.type == "cuda" if graph is None else graph
        auds = np.asarray(auds, np.float32)
        if pose_ids is None:
            pose_ids = [f % len(self.poses) for f in range(len(auds))]
        frames: List[np.ndarray] = []
        diags: Dict[str, list] = {k: [] for k in COUNTERS}

        def emit(base, count, bufs, cnt):
            frames.extend(bufs[j].copy() for j in range(count))
            for i, k in enumerate(COUNTERS):
                diags[k] += [int(v) for v in cnt[:, i]]

        t0 = time.perf_counter()
        self._stream(0, len(auds),
                     lambda f: (pose_ids[f], eyes[f], auds[f]), emit,
                     "yuv420p", use_graph)
        return {"frames": frames, "seconds": time.perf_counter() - t0,
                **diags}


# opt.txt keys that shape the trained model (the JAX session's list)
_TRAINED_KEYS = ("grid_size", "max_steps", "bound", "asr_model", "exp_eye",
                 "ind_dim", "ind_num", "att", "emb", "encoder", "min_near",
                 "density_thresh", "scale", "offset")


def _adopt_trained_config(cfg: Config, workspace: str) -> Config:
    """The architecture fields of the training config saved in the
    workspace's opt.txt (one JSON document per line, the last wins; or a
    legacy multi-line dump); a malformed file keeps cfg."""
    opt_path = os.path.join(workspace, "opt.txt")
    if not os.path.exists(opt_path):
        return cfg
    with open(opt_path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    try:
        try:
            trained = json.loads(lines[-1])
        except json.JSONDecodeError:
            trained = json.loads("{" + text.rsplit("{", 1)[-1])
        return cfg.replace(**{
            k: tuple(trained[k]) if isinstance(trained[k], list)
            else trained[k] for k in _TRAINED_KEYS if k in trained})
    except (ValueError, IndexError, TypeError, AttributeError):
        return cfg


def unported_plan(cfg: Config) -> List[str]:
    """What in cfg asks for a serving path the port does not have, each
    with the ROADMAP item that ports it (empty: the port serves cfg)."""
    q1 = "ROADMAP Queue 1 item"
    checks = (
        (cfg.infer_march_group not in (1, 2), f"infer_march_group "
         f"{cfg.infer_march_group} (group 3 and the dilated modes): {q1} 8"),
        (cfg.infer_sample_frac > 0, "infer_sample_frac > 0 (stage-1 sample "
         f"compaction): {q1} 8"),
        (cfg.infer_data_parallel >= 2, "infer_data_parallel >= 2 "
         f"(frame-parallel serving, parallel/): {q1} 7"),
        (cfg.infer_march_variant != "nb5w", f"infer_march_variant "
         f"{cfg.infer_march_variant!r}: {q1} 8"),
        (not cfg.infer_march_prepass, "infer_march_prepass off (the block "
         f"march without the prepass): {q1} 8"),
        (not cfg.infer_table_bf16, "infer_table_bf16 off (f32 tables; the "
         f"field kernel reads bf16): {q1} 8"),
        (cfg.emb, f"emb (label audio features): {q1} 8"),
        (not cfg.exp_eye, f"exp_eye off (a field without the eye branch): "
         f"{q1} 8"),
    )
    return [msg for bad, msg in checks if bad]


class InferenceSession(_Session):
    """Load once per identity; feed audio features; stream frames (the
    JAX InferenceSession's API and semantics).

    An identity is a dataset directory (transforms_train.json, gt_imgs/,
    ori_imgs/, au.csv, the audio features, bc.jpg unless bg_img names
    another background) and a workspace holding production_state.pkl
    (and optionally opt.txt). The session serves the state's EMA head and
    composites its torso when the state has one, else serves the head
    over the dataset's background. Every field evaluation goes through
    the field kernel's wrapper, whatever Config.fused_field says (its
    values name three implementations of one function in the JAX
    package). graph: run each chunk as a CUDA graph (default: on a GPU).
    Entry points run on "cuda" unless device says otherwise."""

    def __init__(self, cfg: Config, device=None, log=print,
                 graph: Optional[bool] = None):
        # serving overrides of the reference's inference script
        self.cfg = cfg.replace(test=True, test_train=True, smooth_lips=True,
                               smooth_path=True,
                               smooth_path_window=cfg.smooth_path_window
                               or 14)
        self.device = resolve_device(device)
        self.log = log
        self.graph = graph
        self._built = False
        self._carry = False   # the smooth-lips EMA carries into run()
        # frames of the live buffer are dropped in strides of this many
        self._live_trim_stride = 1024

    # -- model/data ----------------------------------------------------------

    def load_model(self, data_path: str, workspace: str) -> None:
        """Switch identity: the dataset at data_path and the trained state
        of `workspace` (its production_state.pkl, else the newest
        checkpoint of the port's CLI with <workspace>_torso's torso:
        state_io.load_workspace_state), with the architecture fields of
        the workspace's opt.txt. The render path follows the JAX
        session's: the 2x2-block path, the per-ray compact render for odd
        frame sides or infer_block 1, the exhaustive marcher at cascade >
        1; the block march steps down to the per-ray march outside its
        drift envelope. Raises when the Config asks for a path the port
        does not have, when the state's grid or head encoder is not the
        Config's, or when there is no state."""
        from ..data.provider import NeRFDataset

        t0 = time.perf_counter()
        self._built = False
        cfg = _adopt_trained_config(
            self.cfg.replace(path=data_path, workspace=workspace), workspace)
        bad = unported_plan(cfg)
        if bad:
            raise NotImplementedError("the port has no serving path for: "
                                      + "; ".join(bad))
        st = load_workspace_state(workspace, use_ema=cfg.use_ema)
        if st is None:
            raise FileNotFoundError(
                f"no trained state in {workspace}: neither "
                "production_state.pkl nor a checkpoint of the port's CLI "
                "under checkpoints/ (orbax checkpoints are not read; "
                "state_io.checkpoint_from_jax converts them)")
        meta = st["meta"]
        if int(meta["grid"]) != cfg.grid_size:
            raise ValueError(f"{workspace} holds a grid of {meta['grid']} "
                             f"cells, the Config grid_size {cfg.grid_size}")
        if head_encoder(st["head"]) != cfg.encoder:
            raise ValueError(f"{workspace} holds a {head_encoder(st['head'])}"
                             f" head, the Config encoder {cfg.encoder!r}")
        ds = NeRFDataset(cfg, type="train")
        ds.training = False
        if (ds.aud_features is not None
                and ds.aud_features.shape[-1] != int(meta["audio_dim"])):
            raise ValueError(f"audio features of width "
                             f"{ds.aud_features.shape[-1]} under {data_path}, "
                             f"the state's audio net reads "
                             f"{meta['audio_dim']}")
        settings = RenderSettings.from_config(cfg)
        if "aabb" in meta:
            # a production state carries the geometry it was trained with
            aabb = tuple(float(x) for x in meta["aabb"])
            dt = float(meta["dt"])
            settings = dataclasses.replace(
                settings, aabb=aabb, dt=dt,
                num_cand=num_candidates(aabb, cfg.min_near, dt))
        settings = dataclasses.replace(
            settings, max_steps=cfg.infer_samples or cfg.max_steps)
        self.cfg, self.ds = cfg, ds
        self._load(st, self.device, settings, ds.H, ds.W, ds.intrinsics,
                   ds.poses, ds.bg_img, self._chunk_size(), att=cfg.att,
                   log=self.log, variants=())
        self.train_camera = bool(cfg.train_camera
                                 and hasattr(self.field, "camera_dT"))
        self.stage_split = cfg.infer_stage_split
        self._budget_override = self._k2_override = 0
        self._eval_override = self._stage2_override = 0
        self._bucket_plan = None
        self._carry = False
        self.resumed = True

        # the render path and march plan (the JAX session's
        # _compile_render)
        use_compact = settings.cascade == 1
        if not use_compact:
            self.log(f"[INFO] bound={cfg.bound} -> cascade="
                     f"{settings.cascade} > 1: serving through the "
                     "exhaustive marcher (render_rays) — slower, "
                     "sample-identical; the fast path needs cascade == 1")
        use_blocks = (use_compact and cfg.infer_block == 2
                      and ds.H % 2 == 0 and ds.W % 2 == 0)
        self.path = ("blocks" if use_blocks else
                     "compact" if use_compact else "full")
        self.k2_planned, group, variant = resolve_march_plan(
            settings, self.tables.z_lo, self.tables.z_hi, self.poses,
            self.intrinsics, self.H, self.W,
            k2_override=cfg.infer_window_candidates,
            march_group=cfg.infer_march_group if use_blocks else 1,
            march_variant=cfg.infer_march_variant,
            measure=(("block" if use_blocks else "ray") if use_compact
                     else None), log=self.log)
        self.march_group = group
        self.use_prepass = (use_blocks and group == 2
                            and cfg.infer_march_prepass)
        self.march_plan = (group, variant, self.use_prepass)
        if use_compact:
            self.tables = ensure_variant_tables(
                self.tables, self.occ.occ, needed_variant_tables(
                    group, variant, prepass=self.use_prepass))
        self._build_plan(t0)
        self._built = True

    def _build_plan(self, t0: float) -> None:
        """The JAX session's _compile_render plan: the ray budget
        budget_frac x the frame in granules, K2, the short/long bucket
        plan measured once per K2 over the dataset's poses (group-2 block
        path with the prepass), the eval budget infer_eval_frac x the ray
        budget (block path), the stage-2 budget infer_stage2_frac x the
        ray budget in 1024-slot steps; the escapes' overrides take the
        place of each."""
        cfg, s = self.cfg, self.settings
        gran, cap = self.gran, self.frame_cap
        frame = self.H * self.W
        budget = min(cap, self._budget_override or max(
            gran, int(cfg.budget_frac * frame) // gran * gran))
        self.k2 = k2 = self._k2_override or self.k2_planned
        bucket = None
        if self.use_prepass and cfg.infer_march_bucket:
            if self._bucket_plan is None or self._bucket_plan[0] != k2:
                k2s, n_short, _, _ = measure_bucket_plan(
                    s, self.tables.z_lo, self.tables.z_hi,
                    self.tables.col_dilwords, self.poses, self.intrinsics,
                    self.H, self.W, k2, log=self.log)
                self._bucket_plan = (k2, k2s, n_short)
            _, k2s, n_short = self._bucket_plan
            bs = bucket_short_budget(n_short, budget, gran) if k2s else 0
            if bs:
                bucket = (k2s, bs)
        eval_budget = 0
        if self.path == "blocks" and cfg.infer_eval_frac > 0:
            eval_budget = min(budget, self._eval_override or max(
                gran, int(budget * cfg.infer_eval_frac) // gran * gran))
        self.budget = budget
        self.bucket = bucket
        self.long_budget = budget - bucket[1] if bucket else 0
        self.eval_budget = eval_budget
        self.stage2_budget = (
            min(self._stage2_override, budget) if self._stage2_override
            else max(1024, int(budget * cfg.infer_stage2_frac) // 1024 * 1024))
        self._plan_line(t0, f"{self.path} path, march group "
                        f"{self.march_group}, from the Config over "
                        f"{len(self.poses)} poses")

    # -- audio ---------------------------------------------------------------

    def set_audio_features(self, feats: np.ndarray) -> int:
        """Inject novel audio features directly; returns the number of
        video frames they drive. Resets the smooth-lips carry."""
        if not self._built:
            raise RuntimeError("load_model first")
        self.ds.aud_features = np.asarray(feats, np.float32)
        self.ds.aud_offset = 0
        self._carry = False
        return len(self.ds.aud_features)

    # -- streaming loop ------------------------------------------------------

    def run(self, sink: Optional[FrameSink] = None,
            max_frames: Optional[int] = None,
            on_frame: Optional[Callable[[int, np.ndarray], None]] = None,
            profile: bool = False,
            start: int = 0, close_sink: bool = True):
        """Render all frames driven by the current audio features, pushing
        each frame's bytes into `sink` in the sink's pix_fmt ("yuv420p" or
        "rgb24") and calling on_frame(index, frame bytes) in order.
        Returns (num_frames, wall_seconds). profile=True logs the host
        phases' wall time every 25 chunks and at the end.

        start/close_sink are the incremental hooks run_live builds on:
        frames [start, max_frames) render with the chunk lattice anchored
        at `start`, and the sink is left open for the next segment. The
        sink is closed when the run fails."""
        if not self._built:
            raise RuntimeError("load_model first")
        acc = PhaseAccumulator() if profile else None
        sink = sink or NullSink()
        ds, cfg = self.ds, self.cfg
        # absolute frame count: a live-trimmed feature buffer carries its
        # start index in ds.aud_offset (provider.audio_window)
        n = (ds.aud_offset + len(ds.aud_features)
             if ds.aud_features is not None else 2 * ds.num_frames)
        if max_frames is not None:
            n = min(n, max_frames)
        t0 = time.time()
        fmt = getattr(sink, "pix_fmt", "rgb24")
        if fmt == "yuv420p" and (self.H % 2 or self.W % 2):
            # 4:2:0 needs even sides: the frame and every sink of the
            # chain (a wrapper's inner sink too) flip to rgb24 before
            # they open
            fmt = "rgb24"
            s = sink
            while s is not None:
                if hasattr(s, "pix_fmt"):
                    if getattr(s, "proc", None) is not None:
                        raise RuntimeError(
                            f"sink already opened as yuv420p but frame size "
                            f"{self.W}x{self.H} is odd — construct the sink "
                            "with pix_fmt='rgb24'")
                    s.pix_fmt = "rgb24"
                s = getattr(s, "inner", None)
        self.chunk = self._chunk_size()
        if not self._carry:
            self.reset_audio()
        use_graph = (self.device.type == "cuda" if self.graph is None
                     else self.graph)

        def frame_inputs(i):
            fi = ds.mirror_index(i)
            eye = cfg.fix_eye if cfg.fix_eye >= 0 else ds.eye_area[fi]
            return fi, eye, ds.audio_window(i)

        def emit(base, count, bufs, cnt):
            for j in range(count):
                frame = bufs[j].copy()
                sink.push(frame.tobytes())
                if on_frame:
                    on_frame(base + j, frame)

        try:
            self._stream(start, n, frame_inputs, emit, fmt, use_graph, acc)
        except BaseException:
            # the sink must not outlive a failed run: an abandoned ffmpeg
            # leaks its pump fd and leaves an 'event' playlist without
            # EXT-X-ENDLIST that players stall on forever. run_live owns
            # the sink when close_sink=False and closes it in its handler.
            if close_sink:
                try:
                    sink.close()
                except Exception as e:
                    self.log(f"[WARN] closing the sink after a failed run: "
                             f"{type(e).__name__}: {e}")
            raise
        self._carry = cfg.smooth_lips
        dt = time.time() - t0
        if close_sink:
            sink.close()
        if acc:
            self.log(f"[profile] total {n - start} frames, {dt:.2f}s: "
                     f"{acc.report()}")
        return n - start, dt

    def _chunk_size(self) -> int:
        """The render chunk size (one definition: run() and run_live()
        must agree, or run_live's mid-stream segments leave the chunk
        lattice and lose their byte-equality with run())."""
        return max(1, self.cfg.infer_chunk)

    def run_live(self, feature_stream, sink: Optional[FrameSink] = None,
                 on_frame: Optional[Callable[[int, np.ndarray], None]] = None):
        """Live serving loop: consume audio features as they arrive and
        render incrementally.

        `feature_stream` yields [k, ...] arrays of per-video-frame features
        (any k >= 0). A frame renders once its attention window's right
        context is buffered (att mode 2 looks 3 frames ahead); the stream
        tail flushes with the same end-of-sequence zero padding as the
        offline path, so the frames are byte-identical to one run() over
        the concatenated features. The smooth-lips EMA is reset at the
        stream's start and carries across its segments, and the chunk
        lattice stays anchored at frame 0, so drip sizes never change the
        output. Features are managed internally (set_audio_features would
        reset the carried EMA). The sink is closed at the end, also on
        failure. Returns (frames, wall_seconds)."""
        if not self._built:
            raise RuntimeError("load_model first")
        cfg = self.cfg
        sink = sink or NullSink()
        # a live stream is a fresh utterance
        self._carry = False
        # right context of the attention window (utils/audio.py offsets)
        lookahead = 3 if cfg.att == 2 else 0
        lookbehind = 8   # widest left reach across att modes 1/2
        C = self._chunk_size()
        buf = None
        offset = 0       # absolute frame index of buf[0] (buffer trimming)
        next_i = 0
        t0 = time.time()

        def set_window(b, off):
            self.ds.aud_features = b
            self.ds.aud_offset = off

        try:
            for feats in feature_stream:
                feats = np.asarray(feats, np.float32)
                if len(feats) == 0:
                    continue
                buf = (feats if buf is None
                       else np.concatenate([buf, feats], 0))
                set_window(buf, offset)
                ready = offset + len(buf) - lookahead
                if ready - next_i >= C:
                    # whole chunks only: keeps the chunk lattice aligned
                    # with the offline run()'s [0,C),[C,2C),... so no tail
                    # padding (and no EMA mask interplay) mid-stream
                    end = next_i + ((ready - next_i) // C) * C
                    self.run(sink, start=next_i, max_frames=end,
                             close_sink=False, on_frame=on_frame)
                    next_i = end
                # bound the buffer for hours-long sessions: frames below
                # next_i - lookbehind can never be windowed again
                keep_from = max(0, next_i - lookbehind)
                if keep_from - offset >= self._live_trim_stride:
                    buf = buf[keep_from - offset:]
                    offset = keep_from
            total = offset + (len(buf) if buf is not None else 0)
            if buf is not None and next_i < total:
                # stream over: the lookahead frames render with the real
                # end-of-sequence zero padding, exactly like offline
                set_window(buf, offset)
                self.run(sink, start=next_i, max_frames=total,
                         close_sink=False, on_frame=on_frame)
                next_i = total
        finally:
            # restore absolute indexing for any later offline use, and
            # always close the sink
            self.ds.aud_offset = 0
            sink.close()
        return next_i, time.time() - t0

