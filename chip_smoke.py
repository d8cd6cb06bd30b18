"""GPU smoke test of the PyTorch/CUDA port (lzzx_nerf_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel from csrc/ (cold or cached);
  3. session: loads trained/production_state.pkl without JAX and plans the
     512² serving frame over the state's 32 poses (K2, the bucket plan,
     ray / short / long / eval / stage-2 budgets);
  4. kernels: each kernel's wrapper on the inputs the main path gives it,
     against its plain PyTorch version on the card, over 96 eager frames
     (the 32 poses x 3 seeded audio windows): the march select equal at
     every launch (both bucket shapes, K2s and K2), the field kernel
     (triplane lookup + SH basis + MLP) within FIELD_TOL at every launch,
     with its largest errors and their share of FIELD_TOL per stage shape
     (stage 1 after the eval re-compaction, stage 2); then kernel /
     plain-version times at the first frame's shapes, the bounds and the
     share of each; the field library's SASS must hold tensor-core (HMMA)
     instructions;
  5. slice: the main path, --frames frames at 512² with torso through the
     session's captured chunk program (CUDA graph), launch counts reset
     just before and read just after (the triplane entry and the select
     must have launched, the enc_x entry, which only a hash head runs,
     must not; replays count the launches their capture recorded);
  6. graph: the same frames through the eager chunk program, byte-equal
     to the captured ones;
  7. frame0: frame 0 rendered again through the plain versions on the card
     must agree within FRAME_TOL;
  8. fps: frames/s eager and captured over the trajectory;
  9. escape: a session over 4 poses that starts with a ray budget below
     its frames' demand warns, rebuilds at a chunk boundary, and renders
     the frames after the rebuild byte-equal to a session built with the
     plan it converged to;
 10. bench: a short run of python3 -m lzzx_nerf_tpu_torch.bench;
 11. train: the head training step (PyTorch autograd; it launches neither
     hand kernel). One full-path and one compacted step at 48², grid 32,
     1,024 rays, S 8 on the card and on the CPU from one seeded init and
     the same explicit draws, at step 32 (the jitter regulariser fires,
     and step_factor 0.32 weighs every loss term), and the regulariser
     alone: the loss or value and every parameter group's gradient agree
     within the CPU parity tests' tolerances
     (tests/test_torch_train_step.py). Then the production point through
     the entry point's HeadRun (512², grid 128, S 16, 65,536 rays, the
     compacted budget 49,152, 32 torso frames, cells no camera sees
     marked, seeded init): TRAIN_WARMUP full-path steps, then
     TRAIN_COMPACT compacted ones, the grid refreshed every 16: steps/s
     of each path, refresh seconds, peak memory, n_active against the
     budget, skipped steps, host syncs per step (sync debug mode), the
     loss of the first and last 30 steps (the last must average under 0.8
     of the first) and the 256² eval PSNR over 4 frames before and after
     (it must rise); then torch.profiler's top-10 kernels of one
     compacted step and the share of the table-gradient scatter; the
     staged compacted step (train_stage_split 4) at 48² card vs CPU at a
     stage-2 budget the survivors overflow and one they fit (n_stage2
     equal); the staged step (split 8, stage-2 budget 16,384) timed in
     turns against the single-pass compacted one at the production point
     (steps/s, n_stage2 against its budget, peak memory); one patch step
     (patch_size 32, LPIPS on the fixed-seed backbone) card vs CPU;
 12. lips: the lips finetune (LPIPS; neither hand kernel). One lips step at
     step 5 (48², grid 32, the 32² crop) on the card and on the CPU from
     one seeded init and the same draws, held to the [train] tolerances;
     then LIPS_STEPS steps at the production point (512², grid 128, the
     64² crop) over the head run: steps/s, peak memory, launch counts;
     and torch.profiler's top kernels of one step;
 13. torso: one torso step at step 5 and one torso refresh (48², grid
     32) on the card against the CPU; then TORSO_STEPS steps at the
     production point (65,536 rays, the torso grid refreshed every 16):
     steps/s, refresh seconds, peak memory, host syncs, the loss (the
     last 30 steps must average lower than the first 30), the torso eval
     PSNR, launch counts; and torch.profiler's top kernels of one step;
 14. recipe: the port's entry point runs head, lips and torso at a reduced
     depth (RECIPE_ARGS) and writes production_state.pkl; a ServingSession
     on the card serves it: one eager chunk with every kernel launch held
     to its plain version, then the chunk captured, launch counts set to
     0 just before and read just after (both kernels must launch), its
     frames byte-equal to the eager ones;
 15. live: tools/identity.py writes the trained state as a 512² dataset
     identity (its 32 poses, intrinsics, landmarks, blinks, seeded
     29-wide features, bc.jpg when the card has an image codec, else a
     white background) and a workspace; the poses the provider loads must
     equal the state's. An InferenceSession (the Config's defaults) loads
     it and settles its plan on LIVE_FRAMES seeded frames; then run()
     renders them into a RawFileSink and run_live renders the same
     features in irregular drips, byte-equal, both kernels launching in
     each (counts set to 0 just before, read just after); one eager chunk
     holds every kernel launch to its plain version; frames/s of run()
     with the sink; the frames after the load that streamed over the
     Config's starting plan; the audio-to-video latency of run_live over
     LATENCY_FRAMES seeded frames (from the segment that completes frame
     i's right context to frame i in the sink), p50 and p95 at chunk 8
     and chunk 1, fed at the browser page's cadence (a post every 1.024
     s, 25-26 frames) and in DRIPS paced at 25 frames/s;
 16. webapi: serve() on 127.0.0.1:0 over the same identity with a raw
     sink: model_select, an .npy upload and GET /api/inference?wait=1
     (after the server's session settles its plan) must write [live]'s
     offline bytes, and a live /api/audio_chunk ... /api/audio_end stream
     of .npy segments the same bytes; both kernels launch in each; the
     wall time of the 64 frames through HTTP.
 17. reference: a reference (LZZX-NeRF) checkpoint from a seed at the
     reference's deepspeech widths (hash head, tiled torso; its density
     grid the trained state's occupancy in Morton order) imported by
     tools/import_reference_ckpt.py over [live]'s 512² identity and
     served by an InferenceSession: the plan settles; an eager run of 64
     frames with every launch held to its plain version (the field
     kernel's enc_x entry within FIELD_TOL, with its worst share; the
     select equal); the same frames captured and timed, byte-equal to
     the eager ones, launch counts set to 0 just before and read just
     after (the enc_x entry and the select launch, the triplane entry
     does not); frames/s eager and captured beside [live]'s dense rate;
     frame 0 through the plain versions within FRAME_TOL; the enc_x entry
     at both stage shapes against its bounds and plain version,
     grid_encode (plain PyTorch) and the tiled torso timed; the frame
     profiled (tools/profile_frame.py: device ms, kernels, the shares of
     grid_encode and the enc_x entry); --test --torso on 4 frames; the
     export (tools/export_reference_ckpt.py) bit for bit equal to the
     imported checkpoint, with its seconds and the import's; the CLI
     trains the hash head and the tiled torso 100 steps each (it/s);
 18. fallback: the serving fallbacks, each through an InferenceSession
     with the Config's defaults and one override (FALLBACK_PATHS) over
     the trained state's 512² identity: the group-1 march, per-ray
     windows (infer_block 1, render_rays_compact), the single-pass
     composite (infer_stage_split 0), a 511² identity into a
     yuv420p-requested sink (the compact path; the sink flips to rgb24),
     and bound 2 (cascade 2, render_rays over a seeded field with every
     cell occupied); the production nb5w path first, for comparison.
     For each: the plan settles, one eager chunk with every kernel launch
     held to its plain version, frame 0 through the kernels against the
     plain versions (FRAME_TOL), the captured run's launch counts (set to
     0 just before, read just after: the field kernel on every path, the
     select only on the group-2 block paths) and frames/s;
 18b. alternates (after [fallback]): the Config alternates of the JAX
     session (ALT_PATHS), each one override over the Config's defaults
     on the trained state's 512² identity: the nine block-march variants
     (wslice, nb_first, zband, zband4, nb5wz, nb5wz4, quad, quadw,
     quadwx), infer_march_group 3 and -2, infer_march_prepass 0,
     infer_table_bf16 0 (float32 tables: the enc_x entry),
     infer_sample_frac ALT_SAMPLE_FRAC (its first plan overflows, so the
     sample escape fires), and seeded exp_eye 0 and emb states at the
     trained state's widths and occupancy; the nb5w path first, then
     nb5w without the bucket split. For each: the plan settles and the
     plan it resolved to (a step-down included), one eager chunk with
     every kernel launch held to its plain version, frame 0 through the
     kernels against the plain versions (FRAME_TOL), the captured run's
     launch counts (set to 0 just before, read just after: the right
     field entry on every path, the select on every group-2 block path,
     each variant marching through it) and frames/s beside nb5w's; the
     frames of ALT_EQUAL_NB5W byte-equal to nb5w's (the nine variants
     over ALT_VARIANT_FRAMES frames, a depth cut), prepass 0's to the
     unbucketed nb5w path's (the bytes that differ from the bucketed one
     printed), those of the quadrant variants byte-equal to each other;
 19. cli: the synthetic oracle as a 512² disk dataset
     (tools/dataset.py); `python -m lzzx_nerf_tpu_torch.cli` trains the
     head at the Config's width (grid 128, S 16, 65,536 rays; CLI_HEAD
     iterations, resumed once from its checkpoint, compacted from
     CLI_WARMUP), the lips finetune with --allow_rand_lpips and the torso
     stage, each a process of its own (steps/s, eval PSNR, which must
     rise); --test --torso in this process with every kernel launch held
     and the launches counted, then timed (frames/s); an InferenceSession
     serves the CLI's workspace (its newest checkpoint and _torso) with
     both kernels launching; the head stage once more with --fp16 0
     (float32) for its rate beside the default bf16 one;
 20. fp16 (after [train]): one bf16 head step (the CLI's field under
     --fp16) at step 32, 48², grid 32, on the card and on the CPU from one
     seeded init and the same draws, held to tests/test_torch_fp16.py's
     step tolerance;
 21. mesh: --save_mesh 1 on [cli]'s workspace at the default 256³: the
     density queries' seconds on the card, the host marcher's, the vertex
     and face counts; one chunk of 65,536 queries card vs CPU;
 22. asr: --asr 1 on [cli]'s workspace, a seeded 5 s wav through a
     stand-in CTC model (29 logits at 50 Hz; no ASR weights are in the
     repository): an eager run at whole-frame budgets with every kernel
     launch held and counted, its raw frames byte-equal to
     InferenceSession.run() over the saved features (--asr_save_feats);
     an eager held run at the Config's budgets, its frame count equal to
     run()'s there and the frames that differ listed; then the default
     captured run at the Config's budgets timed, its launch counts added
     to the main path's in the kernels line;
 23. preprocess: the stand-in identity of tools/synthetic_face.py (BFM
     widths, 100 frames at 512², .lms, a TorchScript parser); tasks 4, 5,
     6, 9 as `python -m lzzx_nerf_tpu_torch.preprocess.process`
     processes on the card, task 8 through the same entry in-process with
     its focal search cut to three of the reference's nine focals,
     tasks 1 and 3 when ffmpeg is on the PATH, task 2 through a stand-in
     HuBERT; the tracker's stage seconds, steps/s and peak memory, its
     recovery of the ground truth at tests/test_face_tracking.py's
     thresholds, and the dataset loaded by the port's provider.
 24. parallel (after [mesh]): on [cli]'s dataset, PAR_STEPS head steps as
     CLI processes: plain, --patch_size 32 --allow_rand_lpips 1 ([patch]:
     it/s beside the plain head's) and --data_parallel 1 (NCCL, a group
     of one: it/s, its checkpoint's parameter moves held to the plain
     run's by the [train] rule); --data_parallel 2 on one card must exit
     with the JAX CLI's message; one compacted data-parallel step at
     world size 1 on the card against world size 2 over gloo on the CPU
     (two processes; loss, n_active, gradients; the CPU ranks bit-equal).
     Serving: an InferenceSession over [live]'s identity with
     infer_data_parallel 2 clamps to the one card and serves [live]'s
     bytes; the frame-parallel program over two replicas on the card
     (the session's devices= seam): one eager chunk with every launch
     held to its plain version, the captured run byte-equal to [live]'s,
     launch counts set to 0 just before and read just after per replica
     (both kernels must launch on each), frames/s beside [live]'s.
Then a "kernels" JSON line (launches: [slice], [asr]'s default run,
[parallel]'s captured frame-parallel run and [alternates]' captured
runs; the enc_x entry's from [reference] and [alternates]), the
nvidia-smi line, and last the device JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

# field kernel vs its plain version: sigma to 1e-4 relative (exp of a sum
# of ~200 float32 products, summed in another order), colors to 1e-5
# absolute (after a sigmoid)
FIELD_TOL = {"sigma_rtol": 1e-4, "sigma_atol": 1e-4, "color_atol": 1e-5}
# frame 0, kernels vs plain versions: 1e-3 absolute on [0, 1] pixels, and
# at most one level on the yuv420 bytes (float order moves rounding)
FRAME_TOL = 1e-3

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# multiply-adds of the field MLP per sample
FIELD_MACS = (36 * 80 + 64 * 32 + 16 + 36 * 64 + 32 * 64 + 64 + 64 * 64
              + 64 * 65 + 64 * 64 + 16 * 64 + 64 * 3)
# the production-point training run: full-path warm-up steps, then
# compacted steps (the recipe's warm-up is 1,000; cut to fit the smoke run)
TRAIN_WARMUP = 120
TRAIN_COMPACT = 120
# card vs CPU on one step: tests/test_torch_train_step.py's tolerances
# (loss; gradients per entry, the share of entries exempt from it for
# ReLU pre-activations within rounding of zero, and the relative L2; the
# regulariser's value)
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_RTOL, TRAIN_GRAD_TAIL = 1e-3, 1e-5
TRAIN_GRAD_EXEMPT, TRAIN_GRAD_L2 = 2e-2, 1e-2
TRAIN_REG_RTOL = 1e-5
# steps of the lips finetune and the torso stage at the production point
# (the recipe runs 2,000 and 100,000; cut to fit the smoke run)
LIPS_STEPS = 60
TORSO_STEPS = 160
# the whole recipe through its entry point, at a reduced depth
# frames of the [live] and [webapi] phases (seeded 29-wide features), the
# irregular drip sizes of their live streams, the live feed's rate
LIVE_FRAMES = 64
DRIPS = (1, 4, 0, 2, 3, 5, 1, 2)
FEED_FPS = 25.0
# the latency check: a longer seeded stream, fed at two cadences. "drips":
# DRIPS, each segment due when its last frame's speech has been spoken at
# FEED_FPS. "player": the browser page's live mode (static/player.html,
# maybeFlushLive) posts a WAV chunk once 16,000 samples are buffered from
# 4,096-sample callbacks, i.e. every PLAYER_POST samples (1.024 s at 16
# kHz); the server's HubertStreamer turns each post into the whole frames
# of 640 samples it completes (25 or 26). 128 frames (5.12 s of speech,
# five posts) keep the script well inside its time limit.
LATENCY_FRAMES = 128
PLAYER_POST = 16384
RECIPE_ARGS = ["--res", "128", "--grid", "64", "--frames", "8",
               "--num-rays", "8192", "--head-iters", "200", "--warmup",
               "100", "--lips-iters", "20", "--lips-pad", "64",
               "--torso-iters", "100", "--eval-every", "100", "--eval-res",
               "128", "--log-every", "10", "--ckpt-every", "100000"]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else f"nvidia-smi failed: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of fn: the calls are queued behind a sleeping
    kernel, so that the events time the card and not the host's enqueue
    (a kernel of tens of microseconds runs faster than its Python wrapper
    can launch it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)     # ~0.1 s at the card's clock
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sass_hmma(path: str):
    """Number of tensor-core (HMMA) instructions in a library's SASS, or
    None where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", path], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    return sum("HMMA" in line for line in r.stdout.splitlines())


def dense_launched(launches: dict) -> bool:
    """A dense head's run launched both kernels of its path (the field
    kernel's triplane entry and the select) and not the enc_x entry."""
    return (launches["fused_field"] > 0 and launches["march_select"] > 0
            and launches["fused_field_enc"] == 0)


def field_errors(out_k, out_p) -> dict:
    """Field kernel output vs its plain version, both [N, 4] = (sigma, rgb):
    the largest errors, the largest share of FIELD_TOL each takes, and
    whether the kernel's output is finite and within FIELD_TOL."""
    import torch

    err_sig = (out_k[:, 0] - out_p[:, 0]).abs()
    sig_share = float((err_sig / (FIELD_TOL["sigma_atol"] + FIELD_TOL[
        "sigma_rtol"] * out_p[:, 0].abs())).max())
    col = float((out_k[:, 1:] - out_p[:, 1:]).abs().max())
    col_share = col / FIELD_TOL["color_atol"]
    fin = bool(torch.isfinite(out_k).all())
    return {"err": float((out_k - out_p).abs().max()),
            "sigma": float(err_sig.max()), "sigma_share": sig_share,
            "color": col, "color_share": col_share,
            "ok": fin and sig_share <= 1.0 and col_share <= 1.0}


@contextlib.contextmanager
def kernels_held(field_checks: list, select_checks: list,
                 captured: dict = None, enc_checks: list = None):
    """Inside the block, every call of a kernel's wrapper (the field
    kernel's fused_field_eval and its enc_x entry's fused_field_enc_eval,
    the march select's march_select) also runs its plain version on the
    same inputs: field launches append (N, field_errors) to field_checks,
    enc_x-entry launches to enc_checks (field_checks when None), select
    launches (G, equal, samples) to select_checks; `captured` keeps the
    first two launches' arguments of each ("field", "enc", "select").
    Eager renders only (a CUDA graph replays no Python)."""
    import torch

    from lzzx_nerf_tpu_torch.ops import fused_field as ff
    from lzzx_nerf_tpu_torch.ops import march2 as m2_mod
    from lzzx_nerf_tpu_torch.ops import march_select as ms
    from lzzx_nerf_tpu_torch.ops.sh import sh_encode

    orig_field, orig_select = ff.fused_field_eval, ms.march_select
    orig_enc = ff.fused_field_enc_eval
    enc_checks = field_checks if enc_checks is None else enc_checks

    def keep(a):
        return tuple(x.clone() if torch.is_tensor(x) else x for x in a)

    def cap_field(*a):
        if captured is not None and len(captured["field"]) < 2:
            captured["field"].append(keep(a))
        out = orig_field(*a)
        fw, pts, dirs, tables, spec, bound = a[:6]
        out_p = ff.field_reference(fw, pts, dirs, tables, spec, bound)
        field_checks.append((pts.shape[0], field_errors(
            torch.cat([out[0][:, None], out[1]], -1), out_p)))
        return out

    def cap_enc(*a):
        if captured is not None and len(captured.setdefault("enc", [])) < 2:
            captured["enc"].append(keep(a))
        out = orig_enc(*a)
        fw, enc_x, dirs = a[:3]
        out_p = ff.fused_field_reference(fw, enc_x, sh_encode(dirs, 4))
        enc_checks.append((enc_x.shape[0], field_errors(
            torch.cat([out[0][:, None], out[1]], -1), out_p)))
        return out

    def cap_select(*a, **k):
        if captured is not None and len(captured["select"]) < 2:
            captured["select"].append(keep(a))
        out = orig_select(*a, **k)
        ref = ms.march_select_reference(*a, **k)
        select_checks.append((a[1].shape[1], bool(torch.equal(out, ref)),
                              int((ref >= 0).sum())))
        return out

    # march2 binds the select wrapper by name; make_fused_apply looks the
    # field wrapper up in its module at each call
    m2_mod.march_select = cap_select
    ff.fused_field_eval = cap_field
    ff.fused_field_enc_eval = cap_enc
    try:
        yield
    finally:
        m2_mod.march_select = orig_select
        ff.fused_field_eval = orig_field
        ff.fused_field_enc_eval = orig_enc


def select_bound(sel_p, a) -> tuple:
    """The least time the select could take on one launch's inputs a (the
    wrapper's arguments) with its plain output sel_p: (bound ms, bound by,
    the bytes, the operations)."""
    import torch

    (table, gx, gy, w0, ro, rd, ts, te, sv, bound, dt, H, K2, S) = a[:14]
    B = ro.shape[0]
    W32 = H // 32
    rows = ((gx.long() * H + gy.long()) * W32 + w0.long())
    uniq = int(torch.unique(rows).numel())
    nbytes = (B * (3 + 3 + 1 + 1) * 4 + B + gx.numel() * 3 * 4
              + uniq * 50 * 4 + B * S * 4)
    # candidates this run's data has the scan test: a ray stops after its
    # S-th sample, else at the first k with k >= K2 or t >= t_end
    k = torch.arange(2 * gx.shape[1], device=ro.device, dtype=torch.float32)
    live = ((ts[:, None] + k[None] * dt < te[:, None]) & sv[:, None]
            & (k[None] < K2)).sum(dim=1)
    tested = int(torch.where(sel_p[:, -1] >= 0, sel_p[:, -1].long() + 1,
                             live).sum())
    # ~40 operations per tested candidate: t (2), three cells (3 x 9),
    # the neighbourhood/word index (~8) and the bit test (~3)
    ops = tested * 40.0
    b = 1e3 * max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    return b, ("operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES
               else "bytes"), nbytes, ops


def _grads_agree(got: dict, want: dict, worst: dict,
                 failed: list = None) -> bool:
    """Every gradient of `got` within the CPU parity tests' tolerance of
    `want`; records the largest error over the largest gradient per
    parameter group in `worst`, and (name, entries outside the rule,
    entries, relative L2) of each parameter that fails in `failed`."""
    import numpy as np

    from lzzx_nerf_tpu_torch.train import param_label_fn

    ok = True
    for n, ref in want.items():
        g = got[n]
        scale = float(np.abs(ref).max())
        err = np.abs(g - ref)
        bad = int((err > TRAIN_GRAD_RTOL * np.abs(ref)
                   + TRAIN_GRAD_TAIL * scale).sum())
        l2 = float(np.linalg.norm(g - ref)
                   / max(np.linalg.norm(ref), 1e-30))
        p_ok = bad <= TRAIN_GRAD_EXEMPT * ref.size and l2 <= TRAIN_GRAD_L2
        ok &= p_ok
        if not p_ok and failed is not None:
            failed.append((n, bad, ref.size, f"{l2:.2e}"))
        lab = param_label_fn(n)
        worst[lab] = max(worst.get(lab, 0.0),
                         float(err.max()) / max(scale, 1e-30))
    return ok


def train_parity(dev) -> tuple:
    """One full-path and one compacted head step at 48², grid 32, 1,024
    rays, S 8 on `dev` and on the CPU from one seeded init and the same
    draws, at step 32 (the jitter regulariser fires, and step_factor 0.32
    weighs it and the uncertainty and ambient losses); then the
    regulariser alone, whose 1e-5 weight hides it inside a step's
    gradient -> (ok, report lines)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.data import (SyntheticTalkingHead,
                                          two_blob_occupancy)
    from lzzx_nerf_tpu_torch.models import NeRFField
    from lzzx_nerf_tpu_torch.render import (RenderSettings,
                                            init_occupancy_state)
    from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                           jitter_regulariser,
                                           make_train_step)

    G, R, N, S, STEP = 32, 48, 1024, 8, 32
    ds = SyntheticTalkingHead(num_frames=8, H=R, W=R)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=G,
                              max_steps=S, dt=2 * 3 ** 0.5 / G, num_cand=28)
    init = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(0)).state_dict()
    frame = ds.frame(0)

    def batch_on(d):
        return {k: int(v) if k == "index" else
                torch.as_tensor(np.array(v), device=d)
                for k, v in frame.items()}

    def field_on(d, state):
        field = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).to(d)
        field.load_state_dict(state)
        return field

    def grads(field):
        return {n: (p.grad.detach().cpu().numpy() if p.grad is not None
                    else np.zeros(tuple(p.shape), np.float32))
                for n, p in field.named_parameters()}

    ok, lines = True, []
    for path, budget in (("full", 0), ("compacted", N)):
        g = torch.Generator().manual_seed(1)
        draws = {"inds": torch.randint(0, R * R, (N,), generator=g),
                 "noise": torch.rand((N,), generator=g),
                 "eye_jitter": torch.rand((1,), generator=g),
                 "reg_delta": torch.rand(((budget or N) * S, 3),
                                         generator=g)}
        out = {}
        for d in (torch.device("cpu"), dev):
            field = field_on(d, init)
            st = TrainState.create(field, HeadOptimizer(
                field.named_parameters(), 1e-2, 1e-3, 100))
            st.step = STEP
            occ = init_occupancy_state(settings, d)._replace(
                occ=two_blob_occupancy(G, d))
            step = make_train_step(field, settings, H=R, W=R,
                                   intrinsics=ds.intrinsics, num_rays=N,
                                   iters=100, train_budget=budget)
            m = step(st, occ, batch_on(d), draws=draws)
            out[d.type] = (float(m["loss"]), grads(field))
        (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[dev.type]
        loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
        worst = {}
        p_ok = _grads_agree(g_dev, g_cpu, worst)
        p_ok &= loss_err <= TRAIN_LOSS_RTOL
        ok &= p_ok
        lines.append(
            f"[train] card vs CPU, {path} step {STEP} (48², grid 32, {N} "
            f"rays, S {S}): loss {l_dev:.7f} vs {l_cpu:.7f} (rel err "
            f"{loss_err:.2e}, tol {TRAIN_LOSS_RTOL}); largest gradient "
            f"error / largest gradient per group "
            f"{ {k: f'{v:.2e}' for k, v in sorted(worst.items())} } "
            f"{'OK' if p_ok else 'FAIL'}")

    # the regulariser alone, on tables in ±0.5 (at the init's ±1e-4 the
    # outputs at pts and pts + delta differ by rounding only)
    g = torch.Generator().manual_seed(2)
    state = {k: ((torch.rand(v.shape, generator=g) - 0.5)
                 if k.startswith("encoder_") else v)
             for k, v in init.items()}
    M = 4096
    pts = (torch.rand((M, 3), generator=g) - 0.5) * 1.2
    dirs = torch.nn.functional.normalize(torch.randn((M, 3), generator=g),
                                         dim=-1)
    mask = torch.rand((M,), generator=g) < 0.7
    delta = (torch.rand((M, 3), generator=g) * 2 - 1) * 1e-3
    out = {}
    for d in (torch.device("cpu"), dev):
        field = field_on(d, state)
        b = batch_on(d)
        reg = jitter_regulariser(
            field, pts.to(d), dirs.to(d), mask.to(d),
            field.encode_audio_train(b["auds"]),
            field.individual_codes[b["index"]], b["eye"] + 0.02,
            delta.to(d), field.bake_train_tables())
        reg.backward()
        out[d.type] = (float(reg.detach()), grads(field))
    (r_cpu, g_cpu), (r_dev, g_dev) = out["cpu"], out[dev.type]
    r_err = abs(r_dev - r_cpu) / max(abs(r_cpu), 1e-30)
    worst = {}
    p_ok = _grads_agree(g_dev, g_cpu, worst)
    p_ok &= r_cpu > 0 and r_err <= TRAIN_REG_RTOL
    ok &= p_ok
    lines.append(
        f"[train] card vs CPU, jitter regulariser alone ({M} samples): "
        f"{r_dev:.7e} vs {r_cpu:.7e} (rel err {r_err:.2e}, tol "
        f"{TRAIN_REG_RTOL}); largest gradient error / largest gradient per "
        f"group { {k: f'{v:.2e}' for k, v in sorted(worst.items())} } "
        f"{'OK' if p_ok else 'FAIL'}")
    return ok, lines


def _card_vs_cpu(dev, build, tag: str) -> tuple:
    """Run build(d) -> (loss, grads) on the CPU and on `dev`; the loss
    within TRAIN_LOSS_RTOL and the gradients to the CPU parity tests' rule
    -> (ok, report line)."""
    import torch

    (l_cpu, g_cpu), (l_dev, g_dev) = (build(torch.device("cpu")),
                                      build(dev))
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    worst, failed = {}, []
    ok = (_grads_agree(g_dev, g_cpu, worst, failed)
          and loss_err <= TRAIN_LOSS_RTOL)
    return ok, (
        f"{tag}: loss {l_dev:.7f} vs {l_cpu:.7f} (rel err {loss_err:.2e}, "
        f"tol {TRAIN_LOSS_RTOL}); largest gradient error / largest gradient "
        f"per group { {k: f'{v:.2e}' for k, v in sorted(worst.items())} } "
        f"{'OK' if ok else f'FAIL {failed}'}")


def _grads_of(module) -> dict:
    import numpy as np

    return {n: (p.grad.detach().cpu().numpy() if p.grad is not None
                else np.zeros(tuple(p.shape), np.float32))
            for n, p in module.named_parameters()}


def lips_parity(dev) -> tuple:
    """One lips step at step 5 (48², grid 32, S 8, the 32² crop at the
    oracle's lips rect, LPIPS on the fixed-seed AlexNet-width backbone) on
    `dev` and on the CPU from one seeded init and the same draws."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.data import (SyntheticTalkingHead,
                                          two_blob_occupancy)
    from lzzx_nerf_tpu_torch.models import NeRFField
    from lzzx_nerf_tpu_torch.render import (RenderSettings,
                                            init_occupancy_state)
    from lzzx_nerf_tpu_torch.tools.train_production import lips_rects
    from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                           make_train_step)
    from lzzx_nerf_tpu_torch.train import lpips as lpips_mod

    G, R, S, PAD, STEP = 32, 48, 8, 32, 5
    ds = SyntheticTalkingHead(num_frames=8, H=R, W=R)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=G,
                              max_steps=S, dt=2 * 3 ** 0.5 / G, num_cand=28)
    init = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(0)).state_dict()
    frame = dict(ds.frame(0), rect_origin=np.asarray(
        lips_rects(ds, R, PAD)[0]))
    g = torch.Generator().manual_seed(3)
    draws = {"noise": torch.rand((PAD * PAD,), generator=g),
             "eye_jitter": torch.rand((1,), generator=g)}

    def build(d):
        field = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).to(d)
        field.load_state_dict(init)
        st = TrainState.create(field, HeadOptimizer(
            field.named_parameters(), 1e-2, 1e-3, 100, finetune_lips=True))
        st.step = STEP
        occ = init_occupancy_state(settings, d)._replace(
            occ=two_blob_occupancy(G, d))
        step = make_train_step(
            field, settings, H=R, W=R, intrinsics=ds.intrinsics,
            num_rays=1024, iters=100, finetune_lips=True, lips_pad=PAD,
            lpips_params=lpips_mod.random_params(device=d))
        b = {k: int(v) if k == "index" else
             torch.as_tensor(np.array(v), device=d) for k, v in frame.items()}
        m = step(st, occ, b, draws=draws)
        return float(m["loss"]), _grads_of(field)

    return _card_vs_cpu(dev, build, f"[lips] card vs CPU, lips step {STEP} "
                        f"(48², grid 32, {PAD}² crop, S {S})")


def torso_parity(dev) -> tuple:
    """One torso step at step 5 (48², grid 32, 1,024 rays, seeded torso
    with its tables in ±0.5, the lower half of the torso grid occupied)
    and one torso refresh (the same jitter) on `dev` and on the CPU ->
    (ok, report lines)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.data import SyntheticTalkingHead
    from lzzx_nerf_tpu_torch.models import TorsoField
    from lzzx_nerf_tpu_torch.render import (RenderSettings,
                                            init_occupancy_state,
                                            make_torso_grid_update)
    from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                           make_torso_train_step)

    G, R, N, STEP = 32, 48, 1024, 5
    ds = SyntheticTalkingHead(num_frames=8, H=R, W=R, torso=True)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=G,
                              max_steps=8, dt=2 * 3 ** 0.5 / G, num_cand=28)
    g = torch.Generator().manual_seed(4)
    # tables in ±0.5, as in tests/test_torch_train_torso.py: at the ±1e-4
    # init the lookup's share of a gradient is rounding, and the deform
    # net's last layer (whose gradient comes only through the lookup)
    # would be compared on noise
    init = {k: ((torch.rand(v.shape, generator=g) - 0.5)
                if k.startswith("torso_encoder_") else v)
            for k, v in TorsoField(ind_num=64).init_params(
                torch.Generator().manual_seed(0)).state_dict().items()}
    frame = dict(ds.frame(3), bg_color=np.ones((R, R, 3), np.float32))
    inds = torch.randint(0, R * R, (N,), generator=g)
    jitter = torch.rand((G * G, 2), generator=g)
    grid = torch.zeros((G, G))
    grid[G // 2:] = 0.5
    grids = {}

    def build(d):
        torso = TorsoField(ind_num=64).to(d)
        torso.load_state_dict(init)
        st = TrainState.create(torso, HeadOptimizer(
            torso.named_parameters(), 1e-2, 1e-3, 100))
        st.step = STEP
        occ = init_occupancy_state(settings, d)._replace(
            density_grid_torso=grid.to(d),
            mean_density_torso=torch.tensor(0.25, device=d))
        b = {k: int(v) if k == "index" else
             torch.as_tensor(np.array(v), device=d) for k, v in frame.items()}
        grids[d.type] = make_torso_grid_update(torso, settings, 8)(
            occ, b["pose"], jitter=jitter.to(d)).density_grid_torso.cpu()
        step = make_torso_train_step(torso, settings, H=R, W=R, num_rays=N)
        m = step(st, occ, b, draws={"inds": inds})
        return float(m["loss"]), _grads_of(torso)

    ok, line = _card_vs_cpu(dev, build, f"[torso] card vs CPU, torso step "
                            f"{STEP} (48², grid 32, {N} rays)")
    a, b = grids[dev.type], grids["cpu"]
    rel = float(((a - b).abs() / b.abs().clamp(min=1e-9)).max())
    r_ok = rel <= 1e-6 and bool((b > 0).any())
    return ok and r_ok, [line, (
        f"[torso] card vs CPU, torso refresh (grid 32, same jitter): largest "
        f"relative difference {rel:.2e} (tol 1e-6) "
        f"{'OK' if r_ok else 'FAIL'}")]


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    a = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - a


def lips_production(run, dev) -> tuple:
    """The lips finetune at the production point over the [train] phase's
    HeadRun (512², grid 128): LIPS_STEPS steps on the 64² crop with the
    default LPIPS weights, both kernels' launch counts around them ->
    (ok, report lines, the LipsRun)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.tools.train_production import LipsRun
    from lzzx_nerf_tpu_torch.train import lpips as lpips_mod

    lips = LipsRun(run, 2000, 64, lpips_mod.get_params(device=dev))
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t, losses = [], []
    for it in range(LIPS_STEPS):
        m, dt = _timed(lambda: lips.step(it))
        t.append(dt)
        losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = dict(kernels.launches)
    skipped, _ = lips.opt.poll(LIPS_STEPS)
    losses = torch.stack(losses).cpu().numpy()
    ok = bool(np.isfinite(losses).all()) and skipped == 0
    med = float(np.median(t[5:]))
    return ok, [
        f"[lips] production point 512², grid 128, 64² lips crop, LPIPS "
        f"{'npz' if lpips_mod.is_pretrained() else 'rand-feat'}: "
        f"{1 / med:.2f} steps/s (median {1e3 * med:.2f} ms over "
        f"{len(t) - 5}); peak memory {peak:.2f} GiB; loss first 10 "
        f"{float(losses[:10].mean()):.6f}, last 10 "
        f"{float(losses[-10:].mean()):.6f}; grad_notfinite {skipped}; "
        f"kernel launches {launches} {'OK' if ok else 'FAIL'}"], lips


def torso_production(run, dev) -> tuple:
    """The torso stage at the production point over the [train] phase's
    HeadRun (512², grid 128, 65,536 rays a step): TORSO_STEPS steps with
    the torso grid refreshed every 16; steps/s, refresh seconds, peak
    memory, the loss of the first and last 30 steps (the last must
    average lower), the 256² torso eval PSNR before and after, both
    kernels' launch counts -> (ok, report lines, the TorsoRun)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.tools.train_production import TorsoRun

    t0 = time.perf_counter()
    torso = TorsoRun(run, 100000)
    torso.refresh_grid(0)
    psnr0, _ = torso.eval_psnr()
    kernels.reset_launches()
    t_step, t_ref, losses = [], [], []
    for it in range(TORSO_STEPS):
        if it % 16 == 0:
            _, dt = _timed(lambda: torso.refresh_grid(it))
            t_ref.append(dt)
        if it == 5:
            torch.cuda.reset_peak_memory_stats(dev)
        m, dt = _timed(lambda: torso.train_step(it))
        t_step.append(dt)
        losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = dict(kernels.launches)
    it = TORSO_STEPS
    syncs = {"none": _syncs(lambda: None),
             "step": _syncs(lambda: [torso.train_step(it + k)
                                     for k in (1, 2, 3)])}
    skipped, _ = torso.opt.poll(it)
    losses = torch.stack(losses).cpu().numpy()
    psnr1, per1 = torso.eval_psnr()
    first, last = float(losses[:30].mean()), float(losses[-30:].mean())
    ok = bool(np.isfinite(losses).all()) and last < first and skipped == 0
    med = float(np.median(t_step[5:]))
    return ok, [
        f"[torso] production point 512², grid 128, {run.num_rays:,} rays "
        f"({torso.n_params():,} parameters): {1 / med:.2f} steps/s (median "
        f"{1e3 * med:.2f} ms over {len(t_step) - 5}); torso refresh (grid "
        f"128, 16,384 alphas) median {np.median(t_ref[1:]):.4f} s over "
        f"{len(t_ref) - 1} (first {t_ref[0]:.3f} s); peak memory "
        f"{peak:.2f} GiB; host syncs over 3 steps {len(syncs['step'])} "
        f"{sorted(set(syncs['step']))} (the empty call before them: "
        f"{len(syncs['none'])}); grad_notfinite {skipped}; kernel launches "
        f"{launches}",
        f"[torso] loss first 30 steps {first:.6f}, last 30 {last:.6f} (must "
        f"be lower); torso eval PSNR 256² over frames {run.eval_frames}: "
        f"{psnr0:.2f} -> {psnr1:.2f} dB {per1} {'OK' if ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)"], torso


def recipe_phase(dev) -> tuple:
    """The port's whole recipe through its entry point at a reduced depth
    (RECIPE_ARGS) into a temporary directory, then a ServingSession on the
    card over the state it wrote: one eager chunk with every kernel launch
    held to its plain version (FIELD_TOL, the select equal), and the same
    chunk captured (CUDA graph) with the launch counts set to 0 just
    before and read just after; its frames byte-equal to the eager ones
    -> (ok, report lines)."""
    import io
    import tempfile

    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.serving import ServingSession
    from lzzx_nerf_tpu_torch.tools import train_production

    lines = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ws:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_production.main(RECIPE_ARGS + ["--workspace", ws])
        ev = [json.loads(x) for x in buf.getvalue().splitlines()]
        t_train = time.perf_counter() - t0
        by = {}
        for e in ev:
            by.setdefault((e["event"], e.get("stage")), []).append(e)
        done = {st: e["minutes"] for (k, st), es in by.items()
                if k == "stage_done" for e in es}
        logs = {st: es[-1] for (k, st), es in by.items() if k == "log"}
        fin = by[("eval_final", "head")][0]
        t_ok = (rc == 0 and ("done", None) in by
                and all(np.isfinite(e["loss"]) and e["grad_notfinite"] == 0
                        for e in ev if e["event"] == "log")
                and np.isfinite(fin["psnr"]) and np.isfinite(fin["lpips"]))
        lines.append(
            f"[recipe] {' '.join(RECIPE_ARGS)}: rc {rc}, {t_train:.1f} s; "
            f"stage minutes {done}; last loss head "
            f"{logs['head']['loss']} ({logs['head']['it_s']} it/s), lips "
            f"{logs['lips']['loss']} ({logs['lips']['it_s']} it/s), torso "
            f"{logs['torso']['loss']} ({logs['torso']['it_s']} it/s); head "
            f"eval {[e['psnr'] for e in by[('eval', 'head')]]} dB, lips "
            f"{by[('eval', 'lips')][0]['psnr']} dB, torso "
            f"{[e['psnr'] for e in by[('eval', 'torso')]]} dB; final "
            f"{fin['res']}² PSNR {fin['psnr']} dB, LPIPS {fin['lpips']} "
            f"({fin['lpips_weights']}) {'OK' if t_ok else 'FAIL'}")

        t1 = time.perf_counter()
        sess = ServingSession(os.path.join(ws, "production_state.pkl"),
                              device=dev, chunk=8, log=lambda m: None)
    rng = np.random.default_rng(7)
    A = int(sess.meta["audio_dim"])
    auds = rng.standard_normal((8, 8, 16, A)).astype(np.float32)
    eyes = [0.15 + 0.1 * np.sin(f / 4) for f in range(8)]
    # the plan first settles on these frames (an escape rebuilds it at the
    # next render), so the eager and the captured chunk share one plan
    rebuilds = 0
    while True:
        sess.reset_audio()
        sess.render(auds, eyes, graph=False)
        if not sess.rebuild_pending() or rebuilds == 3:
            break
        rebuilds += 1
    field_checks, select_checks = [], []
    with kernels_held(field_checks, select_checks):
        sess.reset_audio()
        eager = sess.render(auds, eyes, graph=False)
    settled = not sess.rebuild_pending()
    sess.reset_audio()
    sess.render(auds, eyes)                  # capture, warm up
    sess.reset_audio()
    kernels.reset_launches()
    cap = sess.render(auds, eyes)
    launches = dict(kernels.launches)
    torch.cuda.synchronize()
    f_ok = bool(field_checks) and all(e["ok"] for _, e in field_checks)
    s_ok = bool(select_checks) and all(e for _, e, _ in select_checks)
    same = sum(np.array_equal(a, b)
               for a, b in zip(cap["frames"], eager["frames"]))
    launched = dense_launched(launches)
    s_all = (f_ok and s_ok and launched and same == 8 and settled
             and sess.captures >= 1)
    lines.append(
        f"[recipe] session on the port-written state: {sess.H}² over "
        f"{len(sess.poses)} poses, K2={sess.k2} bucket={sess.bucket} "
        f"budget={sess.budget} eval={sess.eval_budget} stage2="
        f"{sess.stage2_budget} after {rebuilds} rebuild(s), settled "
        f"{settled}; eager chunk of 8: field within FIELD_TOL at "
        f"{sum(e['ok'] for _, e in field_checks)} of {len(field_checks)} "
        f"launches (max share of tol colour "
        f"{max((e['color_share'] for _, e in field_checks), default=0):.3f},"
        f" sigma "
        f"{max((e['sigma_share'] for _, e in field_checks), default=0):.3f}"
        f"), select equal at {sum(e for _, e, _ in select_checks)} of "
        f"{len(select_checks)}; captured chunk launches {launches}, "
        f"{same} of 8 frames byte-equal to eager, max n_active "
        f"{max(cap['n_active'])}/{sess.budget} "
        f"{'OK' if s_all else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
    return t_ok and s_all, lines


def _drips(feats, sizes=DRIPS):
    """feats in segments of the sizes in `sizes`, cycled (0: an empty one)."""
    at, k = 0, 0
    while at < len(feats):
        n = sizes[k % len(sizes)]
        k += 1
        yield feats[at:at + n]
        at += n


def feed_schedule(n: int, cadence: str) -> list:
    """[(start, end, due seconds)] segments of an n-frame live feed at
    `cadence` ("drips" or "player", see LATENCY_FRAMES); a segment is due
    when the speech it carries has been spoken."""
    out, at, k, rem = [], 0, 0, 0
    while at < n:
        if cadence == "drips":
            m = DRIPS[k % len(DRIPS)]
            due = (at + m) / FEED_FPS
        else:
            # HubertStreamer's lattice: whole 640-sample frames past the
            # CNN edge of 80 samples, the rest carried to the next post
            buf = rem + PLAYER_POST
            m = (buf - 80) // 640
            rem = buf - 640 * m
            due = (k + 1) * PLAYER_POST / 16000
        m = min(m, n - at)
        out.append((at, at + m, due))
        at += m
        k += 1
    return out


def paced_latency(sess, feats, chunk: int, cadence: str) -> dict:
    """run_live over feats fed at `cadence` (feed_schedule), at `chunk`
    frames a chunk: each frame's latency from the segment that completes
    its right context (feature i + 3, or the end of the stream) to its
    arrival in the sink, in ms; the rebuilds during the stream; and
    frames/s of an unpaced run() of the same frames at that chunk."""
    import numpy as np

    from lzzx_nerf_tpu_torch.serving.streaming import NullSink

    sess.cfg = sess.cfg.replace(infer_chunk=chunk)
    # capture the chunk's graph before the timed stream
    sess.set_audio_features(feats[:chunk])
    sess.run(NullSink())
    n = len(feats)
    fed, shown, end = {}, {}, []
    rebuilds = sess.rebuilds

    def stream():
        t0 = time.perf_counter()
        for a, b, due in feed_schedule(n, cadence):
            time.sleep(max(0.0, t0 + due - time.perf_counter()))
            now = time.perf_counter()
            for i in range(a, b):
                fed[i] = now
            yield feats[a:b]
        end.append(time.perf_counter())

    sess.run_live(stream(), NullSink(),
                  on_frame=lambda i, b: shown.__setitem__(
                      i, time.perf_counter()))
    lat = np.array([1e3 * (shown[i] - (fed[i + 3] if i + 3 < n
                                       else end[0])) for i in range(n)])
    rebuilds = sess.rebuilds - rebuilds
    # the same frames unpaced, for the rate this chunk size gives
    sess.set_audio_features(feats)
    _, dt = sess.run(NullSink())
    return {"p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "max": float(lat.max()), "frames": len(shown),
            "rebuilds": rebuilds, "fps": n / dt}


def torch_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def live_phase(dev, root: str, smi: str, res=None, n_poses=None,
               frames: int = LIVE_FRAMES,
               latency_frames: int = LATENCY_FRAMES) -> tuple:
    """[live]: the identity (the state's poses at its resolution, or
    n_poses at `res`), the settled plan, run() and run_live byte for byte
    over `frames` frames, both kernels held and launched, frames/s, latency
    over `latency_frames` frames -> (ok, report lines, {"ident", "cfg",
    "feats", "offline"} for [webapi])."""
    import numpy as np

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.config import Config
    from lzzx_nerf_tpu_torch.data.provider import NeRFDataset
    from lzzx_nerf_tpu_torch.serving import InferenceSession
    from lzzx_nerf_tpu_torch.serving.streaming import NullSink, RawFileSink
    from lzzx_nerf_tpu_torch.tools.identity import write_identity

    lines = []
    t0 = time.perf_counter()
    ident = write_identity(root, model="identity", res=res,
                           n_poses=n_poses, seed=0)
    cfg = Config(asr_model="deepspeech", bg_img=ident["bg_img"])
    raw_poses = NeRFDataset(cfg.replace(path=ident["data"])).poses
    poses_ok = bool(np.array_equal(raw_poses, ident["poses"]))
    sess = InferenceSession(cfg, device=dev,
                            log=lambda m: lines.append(f"[live] {m}"))
    sess.load_model(ident["data"], ident["workspace"])
    t_load = time.perf_counter() - t0
    feats = np.random.default_rng(7).standard_normal(
        (frames, 16, 29)).astype(np.float32)
    # the escapes settle the Config's plan on these frames
    settled = False
    for _ in range(4):
        r0 = sess.rebuilds
        sess.set_audio_features(feats)
        sess.run(NullSink())
        if sess.rebuilds == r0 and not sess.rebuild_pending():
            settled = True
            break
    # the frames that streamed over the Config's starting plan (an
    # escape's chunk renders as planned; the rebuild takes the next one)
    over = {m.groups() for m in (
        re.search(r"\[WARN\] frames (\d+)\.\.(\d+)", ln) for ln in lines)
        if m}
    lines.append(
        f"[live] identity {ident['data']}: {len(ident['poses'])} poses at "
        f"{sess.H}², background "
        f"{'bc.jpg' if ident['codec'] else 'white (no image codec)'}, "
        f"provider poses equal the state's {poses_ok}, torso "
        f"{sess.torso is not None}; load {t_load:.1f} s; "
        f"{sum(int(b) - int(a) + 1 for a, b in over)} frame(s) after the "
        f"load streamed over the starting plan; plan after "
        f"{sess.rebuilds} rebuild(s), settled {settled}: K2={sess.k2} "
        f"bucket={sess.bucket} budget={sess.budget} long="
        f"{sess.long_budget} eval={sess.eval_budget} stage2="
        f"{sess.stage2_budget} chunk={sess.chunk} [{smi}]")

    # 1. run() into a raw sink; 2. run_live on the same features
    rebuilds = sess.rebuilds
    off_path = os.path.join(root, "offline.raw")
    sess.set_audio_features(feats)
    kernels.reset_launches()
    n, dt = sess.run(RawFileSink(off_path))
    torch_sync(dev)
    l_run = dict(kernels.launches)
    with open(off_path, "rb") as f:
        offline = f.read()
    live_path = os.path.join(root, "live.raw")
    kernels.reset_launches()
    n_live, dt_live = sess.run_live(_drips(feats), RawFileSink(live_path))
    torch_sync(dev)
    l_live = dict(kernels.launches)
    with open(live_path, "rb") as f:
        same = f.read() == offline
    frame_bytes = sess.H * sess.W * 3
    launched = dense_launched(l_run) and dense_launched(l_live)
    r_ok = (n == n_live == frames and same and launched and poses_ok
            and len(offline) == frames * frame_bytes and settled
            and sess.rebuilds == rebuilds)
    lines.append(
        f"[live] run() {n} frames into a RawFileSink (rgb24, "
        f"{len(offline):,} bytes): {n / dt:.2f} frames/s ({dt:.3f} s), "
        f"launches {l_run}; run_live in drips {DRIPS}: {n_live} frames, "
        f"byte-equal {same}, launches {l_live} [{smi}] "
        f"{'OK' if r_ok else 'FAIL'}")

    # 3. one eager chunk, every kernel launch held to its plain version;
    # its frames are the offline run's first chunk
    field_checks, select_checks = [], []
    eager = {}
    sess.graph = False
    with kernels_held(field_checks, select_checks):
        sess.set_audio_features(feats[:sess.chunk])
        sess.run(on_frame=lambda i, b: eager.__setitem__(i, b))
    sess.graph = None
    e_same = all(eager[i].tobytes() == offline[i * frame_bytes:
                                               (i + 1) * frame_bytes]
                 for i in range(sess.chunk))
    f_ok = bool(field_checks) and all(e["ok"] for _, e in field_checks)
    s_ok = bool(select_checks) and all(e for _, e, _ in select_checks)
    h_ok = f_ok and s_ok and e_same
    lines.append(
        f"[live] eager chunk of {sess.chunk}: field within FIELD_TOL at "
        f"{sum(e['ok'] for _, e in field_checks)} of {len(field_checks)} "
        f"launches (N {sorted({m for m, _ in field_checks})}, max share of "
        f"tol colour "
        f"{max((e['color_share'] for _, e in field_checks), default=0):.3f}"
        f", sigma "
        f"{max((e['sigma_share'] for _, e in field_checks), default=0):.3f}"
        f"), select equal at {sum(e for _, e, _ in select_checks)} of "
        f"{len(select_checks)} (G {sorted({g for g, _, _ in select_checks})}"
        f"); frames byte-equal to the captured run's {e_same} "
        f"{'OK' if h_ok else 'FAIL'}")

    # 4. audio-to-video latency over a longer stream, at chunk 8 and 1,
    # fed at both cadences; the plan settles on its features first
    long_feats = np.random.default_rng(8).standard_normal(
        (latency_frames, 16, 29)).astype(np.float32)
    l_settled = False
    for _ in range(4):
        r0 = sess.rebuilds
        sess.set_audio_features(long_feats)
        sess.run(NullSink())
        if sess.rebuilds == r0 and not sess.rebuild_pending():
            l_settled = True
            break
    l_ok = l_settled
    for cadence in ("player", "drips"):
        sched = feed_schedule(latency_frames, cadence)
        lat = {c: paced_latency(sess, long_feats, c, cadence)
               for c in (8, 1)}
        l_ok = l_ok and all(v["frames"] == latency_frames
                            for v in lat.values())
        sizes = sorted({b - a for a, b, _ in sched})
        lines.append(
            f"[live] audio-to-video latency, {cadence} cadence ("
            f"{len(sched)} segments of {sizes[0]}-{sizes[-1]} frames, the "
            f"last due at {sched[-1][2]:.3f} s): " + "; ".join(
                f"chunk {c}: p50 {v['p50']:.1f} ms, p95 {v['p95']:.1f} ms, "
                f"max {v['max']:.1f} ms over {v['frames']} frames, "
                f"{v['rebuilds']} rebuild(s) in the stream (run() unpaced "
                f"{v['fps']:.2f} frames/s)"
                for c, v in lat.items()) + f" [{smi}] "
            f"{'OK' if l_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
    sess.cfg = sess.cfg.replace(infer_chunk=cfg.infer_chunk)
    ok = r_ok and h_ok and l_ok
    del sess
    return ok, lines, {"ident": ident, "cfg": cfg, "feats": feats,
                       "offline": offline, "fps": n / dt}


def webapi_phase(dev, root: str, live: dict, smi: str) -> tuple:
    """[webapi]: serve() over [live]'s identity with a raw sink; an .npy
    upload with GET /api/inference?wait=1 and a live /api/audio_chunk ...
    /api/audio_end stream must each write [live]'s offline bytes, both
    kernels launching -> (ok, report lines)."""
    import io
    import threading
    import urllib.request

    import numpy as np

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.serving.webapi import serve

    lines = []
    t0 = time.perf_counter()
    raw = os.path.join(root, "webapi.raw")
    httpd = serve(live["cfg"], host="127.0.0.1", port=0, data_root=root,
                  trial_root=root, sink_kind="raw", out_path=raw,
                  device=dev)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(route, body=None, ctype="application/json"):
        req = urllib.request.Request(base + route, body,
                                     {"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    def npy(a):
        bio = io.BytesIO()
        np.save(bio, a)
        return bio.getvalue()

    def raw_bytes():
        with open(raw, "rb") as f:
            return f.read()

    try:
        feats, offline = live["feats"], live["offline"]
        model = os.path.basename(live["ident"]["data"])
        r = call("/api/model_select", json.dumps({"model": model}).encode())
        sess = httpd.state.session
        path = os.path.join(root, model, "utterance.npy")
        np.save(path, feats)
        # an upload resets the smooth-lips carry (each inference after it
        # continues from the last): upload before every run
        def upload():
            return call("/api/audio_upload", json.dumps(
                {"aud_path": path}).encode())

        # the server's session settles its plan on the utterance
        settled = False
        for _ in range(4):
            r0 = sess.rebuilds
            upload()
            call("/api/inference?wait=1")
            if sess.rebuilds == r0 and not sess.rebuild_pending():
                settled = True
                break
        up = upload()
        kernels.reset_launches()
        t1 = time.perf_counter()
        inf = call("/api/inference?wait=1")
        wall = time.perf_counter() - t1
        l_up = dict(kernels.launches)
        up_same = raw_bytes() == offline
        os.remove(raw)
        kernels.reset_launches()
        t1 = time.perf_counter()
        for seg in _drips(feats):
            call("/api/audio_chunk", npy(seg), "application/octet-stream")
        call("/api/audio_end", b"", "application/octet-stream")
        while True:
            st = call("/api/status")
            if not st["busy"]:
                break
            time.sleep(0.02)
        live_wall = time.perf_counter() - t1
        l_live = dict(kernels.launches)
        live_same = raw_bytes() == offline
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    launched = dense_launched(l_up) and dense_launched(l_live)
    n = len(feats)
    ok = (r.get("model") == model and up.get("aud_frames") == n
          and inf.get("done") and inf.get("frames_done") == n
          and inf.get("error") is None and st["error"] is None
          and st["frames_done"] == n and up_same and live_same
          and launched and settled and not th.is_alive())
    lines.append(
        f"[webapi] model_select {r.get('model')!r} ({r.get('frames')} "
        f"frames), .npy upload {up.get('aud_frames')} frames, settled "
        f"{settled} after {sess.rebuilds} rebuild(s); GET "
        f"/api/inference?wait=1: {inf.get('frames_done')} frames in "
        f"{wall:.3f} s through HTTP (the handler polls every 0.2 s; "
        f"{n / wall:.2f} frames/s), raw bytes equal [live]'s "
        f"{up_same}, launches {l_up}; live /api/audio_chunk x "
        f"{sum(1 for _ in _drips(feats))} + /api/audio_end: "
        f"{st['frames_done']} frames, {live_wall:.3f} s to idle, raw bytes "
        f"equal {live_same}, launches {l_live} [{smi}] "
        f"{'OK' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    return ok, lines


# the fallback render paths of [fallback]: (name, Config overrides, the
# identity it serves) over FALLBACK_FRAMES seeded frames; "nb5w" is the
# production block path, the one the others are compared with
FALLBACK_PATHS = (
    ("nb5w", {}, "identity"),
    ("group 1", {"infer_march_group": 1}, "identity"),
    ("infer_block 1", {"infer_block": 1}, "identity"),
    ("stage_split 0", {"infer_stage_split": 0}, "identity"),
    ("odd 511", {}, "odd"),
    ("bound 2", {"bound": 2.0}, "bound2"),
)
FALLBACK_FRAMES = 32
# the CLI's stages at the production width (512², grid 128, S 16, 65,536
# rays; the oracle's 32 frames): head iterations of the first run and of
# the resumed one (compacted from CLI_WARMUP on), the lips finetune's end
# and the torso stage's iterations (the recipe's 100,000 / 125,000 /
# 200,000, cut to fit the smoke run)
CLI_HEAD = (128, 256)
CLI_WARMUP = 128
CLI_LIPS = 320
CLI_TORSO = 96


class _YuvNull:
    """A sink that asks for yuv420p and keeps the bytes it is given."""

    def __init__(self):
        self.pix_fmt = "yuv420p"
        self.frames = []

    def push(self, b):
        self.frames.append(b)

    def close(self):
        pass


def _bound2_workspace(root: str, data: str, dev) -> str:
    """A workspace of the port's CLI at bound 2 (cascade 2) over the
    dataset at `data`: a seeded head field, every cell occupied."""
    import torch

    from lzzx_nerf_tpu_torch import cli
    from lzzx_nerf_tpu_torch.config import Config
    from lzzx_nerf_tpu_torch.data.provider import NeRFDataset
    from lzzx_nerf_tpu_torch.train.optim import HeadOptimizer
    from lzzx_nerf_tpu_torch.train.trainer import Trainer, TrainState

    ws = os.path.join(root, "trial_bound2")
    cfg = Config(path=data, workspace=ws, asr_model="deepspeech", bound=2.0)
    ds = NeRFDataset(cfg)
    _, occ, field = cli._build_world(cfg, ds, dev)
    occ = occ._replace(occ=torch.ones_like(occ.occ))
    state = TrainState.create(field, HeadOptimizer(field.named_parameters()))
    Trainer(ws).save_checkpoint(state, occ)
    with open(os.path.join(ws, "opt.txt"), "w") as f:
        f.write(cfg.to_json(indent=None) + "\n")
    return ws


def fallback_phase(dev, root: str, smi: str, res=None, n_poses=None,
                   frames: int = FALLBACK_FRAMES) -> tuple:
    """[fallback]: each render path of FALLBACK_PATHS served by an
    InferenceSession: one eager chunk with every kernel launch held to
    its plain version, frame 0 through the kernels against the plain
    versions (FRAME_TOL), the captured run's launch counts (set to 0 just
    before, read just after) and frames/s over `frames` frames -> (ok,
    report lines). res / n_poses: the identities at another size (the
    odd one a pixel less), for a rehearsal on the CPU."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.config import Config
    from lzzx_nerf_tpu_torch.serving import InferenceSession
    from lzzx_nerf_tpu_torch.serving.streaming import NullSink
    from lzzx_nerf_tpu_torch.tools.identity import write_identity

    lines = []
    idents = {"identity": write_identity(root, model="fb", res=res,
                                         n_poses=n_poses, seed=0),
              "odd": write_identity(root, model="odd",
                                    res=(res or 512) - 1, n_poses=n_poses,
                                    seed=0)}
    idents["bound2"] = dict(idents["identity"], workspace=_bound2_workspace(
        root, idents["identity"]["data"], dev))
    feats = np.random.default_rng(11).standard_normal(
        (frames, 16, 29)).astype(np.float32)
    ok = True
    fps = {}
    for name, kw, which in FALLBACK_PATHS:
        t0 = time.perf_counter()
        ident = idents[which]
        plan_lines = []
        cfg = Config(asr_model="deepspeech", bg_img=ident["bg_img"], **kw)
        sess = InferenceSession(cfg, device=dev, log=plan_lines.append)
        sess.load_model(ident["data"], ident["workspace"])
        # the escapes settle the Config's plan on these frames
        settled = False
        for _ in range(4):
            r0 = sess.rebuilds
            sess.set_audio_features(feats)
            sess.run(NullSink())
            if sess.rebuilds == r0 and not sess.rebuild_pending():
                settled = True
                break
        # one eager chunk, every kernel launch held
        field_checks, select_checks = [], []
        sess.graph = False
        sink = _YuvNull()
        with kernels_held(field_checks, select_checks):
            sess.set_audio_features(feats[:sess.chunk])
            sess.run(sink)
        sess.graph = None
        f_ok = bool(field_checks) and all(e["ok"] for _, e in field_checks)
        blocks2 = sess.path == "blocks" and sess.march_group == 2
        s_ok = all(e for _, e, _ in select_checks) and (
            bool(select_checks) == blocks2)
        fmt = sink.pix_fmt
        nbytes = sess.H * sess.W * (3 if fmt == "rgb24" else 1.5)
        sizes_ok = all(len(b) == nbytes for b in sink.frames)
        # frame 0 through the kernels and through the plain versions
        with torch.no_grad():
            enc = sess.field.encode_audio(torch.as_tensor(
                sess.ds.audio_window(0), device=dev))
            eye = torch.tensor([float(sess.ds.eye_area[0])], device=dev)
            img_k = sess.render_frame(0, enc, eye, fmt="rgb24")["image"]
            img_p = sess.render_frame(0, enc, eye, use_kernels=False,
                                      fmt="rgb24")["image"]
        d_frame = float((img_k - img_p).abs().max())
        fin = bool(torch.isfinite(img_k).all())
        # the captured run: launch counts and frames/s
        sess.set_audio_features(feats)
        sess.run(_YuvNull())                     # capture, warm up
        sess.set_audio_features(feats)
        kernels.reset_launches()
        out = _YuvNull()
        n, dt = sess.run(out)
        torch_sync(dev)
        launches = dict(kernels.launches)
        launched = launches["fused_field"] > 0 and (
            (launches["march_select"] > 0) == blocks2)
        fps[name] = n / dt
        p_ok = (f_ok and s_ok and sizes_ok and fin and d_frame <= FRAME_TOL
                and launched and settled and n == frames
                and len(out.frames) == n and out.pix_fmt == fmt)
        ok &= p_ok
        info = [m for m in plan_lines if "[INFO]" in m]

        def max_share(key):
            return max((e[key] for _, e in field_checks), default=0)

        lines.append(
            f"[fallback] {name}: {sess.H}x{sess.W} {sess.path} path, march "
            f"plan {sess.march_plan}, cascade {sess.settings.cascade}, "
            f"sink {fmt}; K2={sess.k2} budget={sess.budget} eval="
            f"{sess.eval_budget} stage2={sess.stage2_budget} after "
            f"{sess.rebuilds} rebuild(s), settled {settled}; eager chunk: "
            f"field within FIELD_TOL at "
            f"{sum(e['ok'] for _, e in field_checks)} of {len(field_checks)}"
            f" launches (N {sorted({m for m, _ in field_checks})}, max "
            f"share of tol colour "
            f"{max_share('color_share'):.3f}, sigma "
            f"{max_share('sigma_share'):.3f}), select equal at "
            f"{sum(e for _, e, _ in select_checks)} of "
            f"{len(select_checks)}; frame 0 kernels vs plain max abs "
            f"{d_frame:.3g} (tol {FRAME_TOL}); captured run {n} frames: "
            f"{fps[name]:.2f} frames/s, launches {launches} [{smi}] "
            f"{'OK' if p_ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
        lines += [f"[fallback]   {m}" for m in info]
        del sess
        torch.cuda.empty_cache()
    base = fps.get("nb5w")
    lines.append("[fallback] frames/s against the nb5w block path "
                 f"({base:.2f}): " + ", ".join(
                     f"{k} {v / base:.3f}" for k, v in fps.items()
                     if k != "nb5w") + f" [{smi}]")
    return ok, lines


# [alternates]: the Config alternates of the JAX session, each one
# override over the Config's defaults on the trained state's 512²
# identity (a seeded eye-less or label-audio state where the override
# needs one); the paths whose frames must be byte-equal to the nb5w
# path's once the plan settles (the variants march through nb5w's select,
# so they run ALT_VARIANT_FRAMES frames, a depth cut), and the quadrant
# family, byte-equal among itself; prepass 0 byte-equal to the nb5w path
# without the bucket split (tests/test_torch_alternates.py holds it
# byte-equal to the bucketed path too, on the JAX package's own fixture;
# here the bytes that differ from the bucketed path are printed, as a
# diagnostic: the bucket's whole-group window tightening re-anchors each
# ray's lattice start, which can move a sample depth by a float32 ulp).
# infer_sample_frac 0.05 gives a first plan whose sample budget the
# frames overflow, so its escape fires.
ALT_VARIANTS = ("wslice", "nb_first", "zband", "zband4", "nb5wz", "nb5wz4",
                "quad", "quadw", "quadwx")
ALT_VARIANT_FRAMES = 8
ALT_SAMPLE_FRAC = 0.05
ALT_PATHS = (
    ("nb5w", {}, "identity"),
    ("bucket 0", {"infer_march_bucket": False}, "identity"),
    *((v, {"infer_march_variant": v}, "identity") for v in ALT_VARIANTS),
    ("group 3", {"infer_march_group": 3}, "identity"),
    ("group -2", {"infer_march_group": -2}, "identity"),
    ("prepass 0", {"infer_march_prepass": False}, "identity"),
    ("table_bf16 0", {"infer_table_bf16": False}, "identity"),
    ("sample_frac", {"infer_sample_frac": ALT_SAMPLE_FRAC}, "identity"),
    ("exp_eye 0", {"exp_eye": False}, "eyeless"),
    ("emb", {"emb": True}, "emb"),
)
ALT_EQUAL_NB5W = ALT_VARIANTS + ("sample_frac",)
ALT_QUAD = ("quad", "quadw", "quadwx")
ALT_FRAMES = 32
ALT_SEED = 14


def _seeded_state(src: str, dst: str, seed: int, **field_kw) -> None:
    """A production_state.pkl at `dst`: the state at `src` (its torso,
    occupancy and meta) with a seeded head at the same widths, built
    NeRFField(**field_kw) (exp_eye False: no eye branch; emb: a label
    embedding over the audio width)."""
    import pickle

    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.models import NeRFField
    from lzzx_nerf_tpu_torch.serving.state_io import (TORSO_LEAF_PATHS,
                                                      flatten_paths,
                                                      load_trained_state,
                                                      params_to_jax)

    st = load_trained_state(src)
    meta = st["meta"]
    codes = st["head"]["individual_codes"]
    field = NeRFField(audio_in_dim=int(meta["audio_dim"]),
                      ind_dim=int(np.shape(codes)[1]),
                      ind_num=int(np.shape(codes)[0]), **field_kw)
    field.init_params(torch.Generator().manual_seed(seed))
    tflat = flatten_paths(st["torso"])
    with open(dst, "wb") as f:
        pickle.dump({"head_ema": params_to_jax(field.state_dict()),
                     "torso_leaves": [tflat[p] for p in TORSO_LEAF_PATHS],
                     "occ": st["occ"], "meta": meta}, f)


def alternates_phase(dev, root: str, smi: str, res=None, n_poses=None,
                     frames: int = ALT_FRAMES) -> tuple:
    """[alternates]: each path of ALT_PATHS served by an InferenceSession
    over the trained state's identity (or its seeded eye-less / label
    state): the plan settles (the one it resolved to reported, a
    step-down included), one eager chunk with every kernel launch held to
    its plain version, frame 0 through the kernels against the plain
    versions (FRAME_TOL), the captured run's launch counts (set to 0 just
    before, read just after: the field kernel's triplane entry on every
    bf16-table path, its enc_x entry with float32 tables, the select on
    every group-2 block path) and frames/s beside nb5w's; the
    byte-equalities of ALT_EQUAL_NB5W (over the frames each path ran)
    and ALT_QUAD -> (ok, report lines, the captured runs' summed
    launches)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.config import Config
    from lzzx_nerf_tpu_torch.serving import InferenceSession
    from lzzx_nerf_tpu_torch.serving.streaming import NullSink
    from lzzx_nerf_tpu_torch.tools.identity import write_identity

    lines = []
    idents = {"identity": write_identity(root, model="alt", res=res,
                                         n_poses=n_poses, seed=0)}
    base_state = os.path.join(idents["identity"]["workspace"],
                              "production_state.pkl")
    for name, kw in (("eyeless", dict(exp_eye=False)),
                     ("emb", dict(emb=True))):
        ws = os.path.join(root, f"trial_alt_{name}")
        os.makedirs(ws, exist_ok=True)
        _seeded_state(base_state, os.path.join(ws, "production_state.pkl"),
                      ALT_SEED, **kw)
        idents[name] = dict(idents["identity"], workspace=ws)
    feats = np.random.default_rng(11).standard_normal(
        (frames, 16, 29)).astype(np.float32)
    labels = feats.argmax(-1).astype(np.float32)
    ok = True
    fps, outs = {}, {}
    total = {k: 0 for k in kernels.launches}
    for name, kw, which in ALT_PATHS:
        t0 = time.perf_counter()
        ident = idents[which]
        f_in = labels if kw.get("emb") else feats
        if name in ALT_VARIANTS:
            f_in = f_in[:ALT_VARIANT_FRAMES]
        plan_lines = []
        cfg = Config(asr_model="deepspeech", bg_img=ident["bg_img"], **kw)
        sess = InferenceSession(cfg, device=dev, log=plan_lines.append)
        sess.load_model(ident["data"], ident["workspace"])
        settled = False
        for _ in range(4):
            r0 = sess.rebuilds
            sess.set_audio_features(f_in)
            sess.run(NullSink())
            if sess.rebuilds == r0 and not sess.rebuild_pending():
                settled = True
                break
        group, variant, prepass = sess.march_plan
        select_path = sess.path == "blocks" and group == 2
        f32 = not cfg.infer_table_bf16
        field_checks, select_checks = [], []
        sess.graph = False
        with kernels_held(field_checks, select_checks):
            sess.set_audio_features(f_in[:sess.chunk])
            sess.run(_YuvNull())
        sess.graph = None
        f_ok = bool(field_checks) and all(e["ok"] for _, e in field_checks)
        s_ok = all(e for _, e, _ in select_checks) and (
            bool(select_checks) == select_path)
        with torch.no_grad():
            sess.set_audio_features(f_in)
            enc = sess.field.encode_audio(torch.as_tensor(
                sess.ds.audio_window(0), device=dev))
            eye = torch.tensor([float(sess.ds.eye_area[0])
                                if cfg.exp_eye else 0.0], device=dev)
            img_k = sess.render_frame(0, enc, eye, fmt="rgb24")["image"]
            img_p = sess.render_frame(0, enc, eye, use_kernels=False,
                                      fmt="rgb24")["image"]
        d_frame = float((img_k - img_p).abs().max())
        fin = bool(torch.isfinite(img_k).all())
        sess.set_audio_features(f_in)
        sess.run(_YuvNull())                     # capture, warm up
        sess.set_audio_features(f_in)
        kernels.reset_launches()
        out = _YuvNull()
        n, dt = sess.run(out)
        torch_sync(dev)
        launches = dict(kernels.launches)
        entry = "fused_field_enc" if f32 else "fused_field"
        other = "fused_field" if f32 else "fused_field_enc"
        launched = (launches[entry] > 0 and launches[other] == 0 and (
            (launches["march_select"] > 0) == select_path))
        for k, v in launches.items():
            total[k] += v
        fps[name] = n / dt
        outs[name] = out.frames
        p_ok = (f_ok and s_ok and fin and d_frame <= FRAME_TOL and launched
                and settled and n == len(f_in) and len(out.frames) == n)
        ok &= p_ok

        def max_share(key):
            return max((e[key] for _, e in field_checks), default=0)

        lines.append(
            f"[alternates] {name}: {sess.H}x{sess.W} {sess.path} path, "
            f"resolved plan (group, variant, prepass) {sess.march_plan}; "
            f"K2={sess.k2} budget={sess.budget} eval={sess.eval_budget} "
            f"stage2={sess.stage2_budget} sample={sess.sample_budget} "
            f"after {sess.rebuilds} rebuild(s), settled {settled}; eager "
            f"chunk: {entry} within FIELD_TOL at "
            f"{sum(e['ok'] for _, e in field_checks)} of {len(field_checks)}"
            f" launches (max share of tol colour "
            f"{max_share('color_share'):.3f}, sigma "
            f"{max_share('sigma_share'):.3f}), select equal at "
            f"{sum(e for _, e, _ in select_checks)} of "
            f"{len(select_checks)}; frame 0 kernels vs plain max abs "
            f"{d_frame:.3g} (tol {FRAME_TOL}); captured run {n} frames: "
            f"{fps[name]:.2f} frames/s, launches {launches} [{smi}] "
            f"{'OK' if p_ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
        lines += [f"[alternates]   {m}" for m in plan_lines
                  if "[INFO]" in m or "[WARN]" in m]
        del sess
        torch.cuda.empty_cache()
    base = outs["nb5w"]
    for name in ALT_EQUAL_NB5W:
        eq = outs[name] == base[:len(outs[name])]
        ok &= eq
        lines.append(f"[alternates] {name} frames byte-equal to nb5w's: "
                     f"{eq} {'OK' if eq else 'FAIL'}")
    p_eq = outs["prepass 0"] == outs["bucket 0"]
    ok &= p_eq

    def byte_diff(a, b):
        d = [np.abs(np.frombuffer(x, np.uint8).astype(int)
                    - np.frombuffer(y, np.uint8).astype(int))
             for x, y in zip(a, b)]
        return sum(int((x > 0).sum()) for x in d), max(int(x.max())
                                                        for x in d)

    nd, mx = byte_diff(outs["prepass 0"], base)
    lines.append(f"[alternates] prepass 0 frames byte-equal to the nb5w "
                 f"path's without the bucket split: {p_eq} "
                 f"{'OK' if p_eq else 'FAIL'}; diagnostic, against the "
                 f"bucketed nb5w path: {nd} of {len(base) * len(base[0])} "
                 f"bytes differ, by at most {mx} level(s)")
    q_eq = all(outs[q] == outs[ALT_QUAD[0]] for q in ALT_QUAD)
    ok &= q_eq
    lines.append(f"[alternates] quad, quadw, quadwx frames byte-equal to "
                 f"each other: {q_eq} {'OK' if q_eq else 'FAIL'}")
    b = fps["nb5w"]
    lines.append("[alternates] frames/s against the nb5w path "
                 f"({b:.2f}): " + ", ".join(
                     f"{k} {v:.2f} ({v / b:.3f})" for k, v in fps.items()
                     if k != "nb5w") + f" [{smi}]")
    return ok, lines, total


# [reference]: the reference-layout checkpoint's seed and identity count
# (the reference's default ind_num), the CLI steps that train it further
# and the --test frames
REF_SEED = 12
REF_IND_NUM = 10_000
REF_HEAD_STEPS = 100
REF_TORSO_STEPS = 100
REF_TEST_FRAMES = 4


def reference_checkpoint(path: str, torso_path: str, state_path: str,
                         seed: int = REF_SEED) -> tuple:
    """A reference (LZZX-NeRF) checkpoint from a numpy seed, in the
    reference's layout at its deepspeech widths (audio_in_dim 29, grid
    128, bound 1): the hash head (three 163,584-row tables), the audio
    nets, the five MLPs, REF_IND_NUM individual codes; its density_grid
    the occupancy of `state_path` (20 where occupied, 0 elsewhere), in
    the reference's Morton order; and the torso's (the tiled table, its
    MLPs, anchors, codes, the state's torso grid) at torso_path.
    Returns (head state dict, torso state dict, natural-order grid) as
    numpy."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.models.nerf import (torso_tiled_spec,
                                                 triplane_spec)
    from lzzx_nerf_tpu_torch.ops.morton import morton_perm
    from lzzx_nerf_tpu_torch.serving.state_io import load_trained_state

    rng = np.random.default_rng(seed)

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {}
    for (cin, cout), lyr in zip(((29, 32), (32, 32), (32, 64), (64, 64)),
                                (0, 2, 4, 6)):
        sd[f"audio_net.encoder_conv.{lyr}.weight"] = r(cout, cin, 3)
        sd[f"audio_net.encoder_conv.{lyr}.bias"] = r(cout)
    for (cin, cout), lyr in zip(((64, 64), (64, 32)), (0, 2)):
        sd[f"audio_net.encoder_fc1.{lyr}.weight"] = r(cout, cin)
        sd[f"audio_net.encoder_fc1.{lyr}.bias"] = r(cout)
    for (cin, cout), lyr in zip(((32, 16), (16, 8), (8, 4), (4, 2), (2, 1)),
                                (0, 2, 4, 6, 8)):
        sd[f"audio_att_net.attentionConvNet.{lyr}.weight"] = r(cout, cin, 3)
        sd[f"audio_att_net.attentionConvNet.{lyr}.bias"] = r(cout)
    sd["audio_att_net.attentionNet.0.weight"] = r(8, 8)
    sd["audio_att_net.attentionNet.0.bias"] = r(8)
    for name, dims in (("sigma_net", ((69, 64), (64, 64), (64, 65))),
                       ("color_net", ((84, 64), (64, 3))),
                       ("unc_net", ((36, 32), (32, 1))),
                       ("aud_ch_att_net", ((36, 64), (64, 32))),
                       ("eye_att_net", ((36, 16), (16, 1)))):
        for lyr, (cin, cout) in enumerate(dims):
            sd[f"{name}.net.{lyr}.weight"] = r(cout, cin)
    rows = triplane_spec(1.0).total_params
    for p in ("xy", "yz", "xz"):
        sd[f"encoder_{p}.embeddings"] = r(rows, 1)
    sd["individual_codes"] = r(REF_IND_NUM, 4)
    st = load_trained_state(state_path)
    natural = np.where(np.asarray(st["occ"]["occ"]), 20.0, 0.0).astype(
        np.float32)
    H = natural.shape[-1]
    flat = np.zeros((natural.shape[0], H ** 3), np.float32)
    flat[:, morton_perm(H)] = natural.reshape(natural.shape[0], -1)
    sd["density_grid"] = flat
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "mean_density": float(natural.mean()), "global_step": 0,
                "epoch": 35}, path)

    tsd = {"anchor_points": np.asarray(
        [[0.01, 0.01, 0.1, 1.0], [-0.1, -0.1, 0.1, 1.0],
         [0.1, -0.1, 0.1, 1.0]], np.float32),
        "torso_encoder.embeddings": r(torso_tiled_spec().total_params, 2),
        "individual_codes_torso": r(REF_IND_NUM, 8)}
    for name, dims in (("torso_deform_net", ((84, 32), (32, 32), (32, 2))),
                       ("torso_net", ((116, 32), (32, 32), (32, 4)))):
        for lyr, (cin, cout) in enumerate(dims):
            tsd[f"{name}.net.{lyr}.weight"] = r(cout, cin)
    tsd["density_grid_torso"] = np.asarray(
        st["occ"]["density_grid_torso"], np.float32).reshape(-1)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in tsd.items()},
                "mean_density_torso": float(
                    st["occ"]["mean_density_torso"]), "global_step": 0},
               torso_path)
    return sd, tsd, natural


def reference_phase(dev, root: str, smi: str, live: dict,
                    state_path: str) -> tuple:
    """[reference]: a reference checkpoint (reference_checkpoint) imported
    by tools/import_reference_ckpt.py over [live]'s 512² identity; an
    InferenceSession serves it (hash head, tiled torso): its plan settles,
    then every launch of an eager run is held to its plain version (the
    enc_x entry within FIELD_TOL, the select equal); the same frames
    captured, timed, byte-equal to the eager ones, with the launch counts
    set to 0 just before and read just after (the enc_x entry and the
    select must launch, the triplane entry must not); frames/s eager and
    captured beside [live]'s dense rate; frame 0 through the plain
    versions within FRAME_TOL; the enc_x entry timed at both stage shapes
    against its bounds and plain version, grid_encode and the tiled
    torso timed; the frame profiled (tools/profile_frame.py); --test on
    REF_TEST_FRAMES frames; the export (tools/export_reference_ckpt.py)
    bit for bit equal to the imported checkpoint; then the CLI trains the
    hash head and the tiled torso further -> (ok, report lines, the
    enc_x entry's kernels-line row)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import cli, kernels
    from lzzx_nerf_tpu_torch.ops import fused_field as ff
    from lzzx_nerf_tpu_torch.ops.sh import sh_encode
    from lzzx_nerf_tpu_torch.render.renderer import run_torso_compact
    from lzzx_nerf_tpu_torch.serving import InferenceSession
    from lzzx_nerf_tpu_torch.serving.streaming import NullSink
    from lzzx_nerf_tpu_torch.tools import (export_reference_ckpt,
                                           import_reference_ckpt)
    from lzzx_nerf_tpu_torch.tools.profile_frame import profile_identity

    lines = []
    ok = True
    quiet = lambda m: None  # noqa: E731
    ident, feats = live["ident"], live["feats"]
    data = ident["data"]
    pth = os.path.join(root, "reference.pth")
    tpth = os.path.join(root, "reference_torso.pth")
    sd, tsd, natural = reference_checkpoint(pth, tpth, state_path)
    ws = os.path.join(root, "trial_reference")
    t0 = time.perf_counter()
    imp = import_reference_ckpt.main(
        ["--ckpt", pth, "--data", data, "--workspace", ws, "--torso-ckpt",
         tpth, "--asr_model", "deepspeech", "--grid_size", "128"],
        log=quiet)
    t_import = time.perf_counter() - t0
    i_ok = imp["missing"] == [] and imp["occupied"] == int(
        (natural > 0).sum())
    ok &= i_ok
    lines.append(
        f"[reference] a reference checkpoint (seed {REF_SEED}; hash head "
        f"3 x {sd['encoder_xy.embeddings'].shape[0]:,} rows, tiled torso "
        f"{tsd['torso_encoder.embeddings'].shape[0]:,} x 2, "
        f"{REF_IND_NUM} codes, deepspeech 29, grid 128; density grid the "
        f"trained state's occupancy, {int((natural > 0).sum()):,} cells, "
        f"Morton order) imported over {data} in {t_import:.2f} s: "
        f"{imp['occupied']:,} occupied cells, missing {imp['missing']} "
        f"{'OK' if i_ok else 'FAIL'}")

    t0 = time.perf_counter()
    sess = InferenceSession(live["cfg"], device=dev,
                            log=lambda m: lines.append(f"[reference] {m}"))
    sess.load_model(data, ws)
    t_load = time.perf_counter() - t0
    settled = False
    for _ in range(4):
        r0 = sess.rebuilds
        sess.set_audio_features(feats)
        sess.run(NullSink())
        if sess.rebuilds == r0 and not sess.rebuild_pending():
            settled = True
            break
    kinds_ok = (sess.field.encoder == "hash" and sess.torso is not None
                and sess.torso.encoder == "tiled")
    lines.append(
        f"[reference] InferenceSession: head {sess.field.encoder}, torso "
        f"{sess.torso.encoder if sess.torso is not None else None}, load "
        f"{t_load:.1f} s; plan after {sess.rebuilds} rebuild(s), settled "
        f"{settled}: K2={sess.k2} bucket={sess.bucket} budget={sess.budget}"
        f" long={sess.long_budget} eval={sess.eval_budget} stage2="
        f"{sess.stage2_budget} {'OK' if kinds_ok and settled else 'FAIL'}")
    ok &= kinds_ok and settled

    # every launch of an eager run held; the grid encode's first inputs
    # kept for its timing
    field_checks, select_checks, enc_checks = [], [], []
    captured = {"field": [], "select": []}
    enc_pts = []
    encode_x = sess.field.encode_x

    def keep_pts(pts, *a, **k):
        if len(enc_pts) < 2:
            enc_pts.append(pts.clone())
        return encode_x(pts, *a, **k)

    eager = {}
    sess.graph = False
    sess.field.encode_x = keep_pts
    t0 = time.perf_counter()
    try:
        with kernels_held(field_checks, select_checks, captured,
                          enc_checks):
            sess.set_audio_features(feats)
            sess.run(on_frame=lambda i, b: eager.__setitem__(i, b))
    finally:
        del sess.field.encode_x
        sess.graph = None
    e_ok = (bool(enc_checks) and all(e["ok"] for _, e in enc_checks)
            and not field_checks)
    s_ok = bool(select_checks) and all(e for _, e, _ in select_checks)
    ok &= e_ok and s_ok
    lines.append(
        f"[reference] eager run of {len(eager)} frames, every launch held: "
        f"enc_x entry within FIELD_TOL at "
        f"{sum(e['ok'] for _, e in enc_checks)} of {len(enc_checks)} "
        f"launches (N {sorted({m for m, _ in enc_checks})[:4]}..., max "
        f"share of tol colour "
        f"{max((e['color_share'] for _, e in enc_checks), default=0):.3f}, "
        f"sigma "
        f"{max((e['sigma_share'] for _, e in enc_checks), default=0):.3f}),"
        f" triplane entry launches {len(field_checks)}; select equal at "
        f"{sum(e for _, e, _ in select_checks)} of {len(select_checks)} "
        f"{'OK' if e_ok and s_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # the main path of this slice: captured, timed, counts around it
    sess.set_audio_features(feats)
    sess.run(NullSink())                 # capture, warm up
    cap = {}
    sess.set_audio_features(feats)
    kernels.reset_launches()
    n, dt = sess.run(on_frame=lambda i, b: cap.__setitem__(i, b))
    torch_sync(dev)
    launches = dict(kernels.launches)
    same = sum(np.array_equal(cap[i], eager.get(i)) for i in cap)
    launched = (launches["fused_field_enc"] > 0
                and launches["march_select"] > 0
                and launches["fused_field"] == 0)
    c_ok = launched and same == len(eager) == n == len(feats)
    ok &= c_ok
    fps = {"eager": [], "captured": [n / dt]}
    for graph in (False, None, False):
        sess.graph = graph
        sess.set_audio_features(feats)
        m, sec = sess.run(NullSink())
        fps["eager" if graph is False else "captured"].append(m / sec)
    sess.graph = None
    lines.append(
        f"[reference] captured run of {n} frames: {same} byte-equal to the "
        f"eager run, launches {launches} "
        f"{'OK' if c_ok else 'FAIL'}; frames/s at {sess.H}², in turns: "
        f"eager {', '.join(f'{v:.2f}' for v in fps['eager'])}, captured "
        f"{', '.join(f'{v:.2f}' for v in fps['captured'])}; the dense "
        f"identity's [live] run() {live['fps']:.2f} [{smi}]")

    # frame 0 through the plain versions on the card
    win = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (8, 16, 29)).astype(np.float32), device=dev)
    eye0 = torch.tensor([0.25], device=dev)
    out = {}
    for use in (True, False):
        sess.reset_audio()
        enc = sess.encode_audio(win)
        out[use] = sess.render_frame(0, enc, eye0, use_kernels=use,
                                     fmt="rgb24")
    torch_sync(dev)
    img_err = float((out[True]["image"] - out[False]["image"]).abs().max())
    rgb_err = int((out[True]["rgb"].int() - out[False]["rgb"].int()).abs()
                  .max())
    f0_ok = (img_err <= FRAME_TOL and rgb_err <= 1
             and bool(torch.isfinite(out[True]["image"]).all())
             and int(out[True]["n_active"]) == int(out[False]["n_active"]))
    ok &= f0_ok
    lines.append(f"[reference] frame 0 kernels vs plain: max_abs_err="
                 f"{img_err:.3g} rgb_max_diff={rgb_err} n_active="
                 f"{int(out[True]['n_active'])} "
                 f"{'OK' if f0_ok else 'FAIL'}")

    # the enc_x entry at both stage shapes, grid_encode, the tiled torso
    rows = []
    for stage, ((fw, enc_x, dirs, wpack), pts) in enumerate(
            zip(captured["enc"][:2], enc_pts), 1):
        nn_ = enc_x.shape[0]
        e = enc_checks[stage - 1][1]
        flops = 2.0 * FIELD_MACS * nn_
        nbytes = nn_ * (36 + 3 + 4) * 4 + ff.W_TOTAL * 4
        b_bytes = 1e3 * nbytes / PEAK_BYTES
        b_tc = max(1e3 * 3 * flops / PEAK_TF32_FLOPS, b_bytes)
        b_f32 = max(1e3 * flops / PEAK_F32_FLOPS, b_bytes)
        ms_k = cuda_time_ms(lambda: ff.fused_field_enc_cuda(enc_x, dirs,
                                                            wpack))
        ms_p = cuda_time_ms(lambda: ff.fused_field_reference(
            fw, enc_x, sh_encode(dirs, 4)), reps=5, warmup=1)
        with torch.no_grad():
            ms_g = cuda_time_ms(lambda: sess.field.encode_x(pts), reps=5,
                                warmup=1)
        rows.append({"err": e["err"], "ms": ms_k, "plain_ms": ms_p,
                     "bound": b_tc, "by": "operations" if b_tc > b_bytes
                     else "bytes"})
        lines.append(
            f"[kernel] fused_field_enc stage {stage} N={nn_} "
            f"max_abs_err={e['err']:.3g} ms={ms_k:.4f} plain_ms={ms_p:.4f} "
            f"bound_ms 3xTF32={b_tc:.4f} (share {b_tc / ms_k:.3f}) "
            f"f32-FMA={b_f32:.4f} bytes={b_bytes:.4f} (172 B a sample and "
            f"the weights once); grid_encode of the {pts.shape[0]} points "
            f"{ms_g:.4f} ms (plain PyTorch) [{smi}]")
    inv_t = sess.pose_inv_t[0]

    def torso_pass():
        return run_torso_compact(
            lambda c, p, code: sess.torso(c, p, code, sess.torso_packed,
                                          inv_t),
            sess.torso_plan, sess.poses_dev[0],
            sess.torso.individual_codes_torso[0], sess.bg)

    ms_torso = cuda_time_ms(torso_pass, reps=10, warmup=2)
    lines.append(f"[reference] tiled torso pass over "
                 f"{int((sess.torso_plan.idx < sess.H * sess.W).sum()):,} "
                 f"pixels: {ms_torso:.4f} ms a frame [{smi}]")

    # one hash frame profiled, eager and captured
    p_lines, p_stats = profile_identity(sess, feats[:16])
    shown = 0
    for ln in p_lines:
        # each section's top 10 kernels
        shown = 0 if ln.startswith("==") else shown + 1
        if shown <= 13:
            lines.append(f"[profile] {ln}")
    ok &= all(p_stats.values())
    del sess
    torch.cuda.empty_cache()

    # --test on a few frames of the identity, the launches counted
    t0 = time.perf_counter()
    test_argv = [data, "--workspace", ws, "--encoder", "hash",
                 "--asr_model", "deepspeech", "--test", "1",
                 "--test_train", "1", "--torso", "1", "--budget_frac",
                 "0.75", "--data_range", "0", str(REF_TEST_FRAMES)]
    if ident["bg_img"]:
        test_argv += ["--bg_img", ident["bg_img"]]
    kernels.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.run_test(*cli.parse_args(test_argv))
    torch_sync(dev)
    t_launches = dict(kernels.launches)
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    t_ok = (len(pngs) == REF_TEST_FRAMES
            and t_launches["fused_field_enc"] > 0
            and t_launches["fused_field"] == 0)
    ok &= t_ok
    lines.append(f"[reference] --test --torso on {REF_TEST_FRAMES} frames: "
                 f"{len(pngs)} PNGs, launches {t_launches} "
                 f"{'OK' if t_ok else 'FAIL'} "
                 f"({time.perf_counter() - t0:.1f} s)")

    # the export, bit for bit the imported checkpoint
    out_pth = os.path.join(root, "exported.pth")
    t0 = time.perf_counter()
    export_reference_ckpt.main(
        ["--workspace", ws, "--data", data, "--out", out_pth,
         "--torso-workspace", ws + "_torso", "--asr_model", "deepspeech",
         "--grid_size", "128"], log=quiet)
    t_export = time.perf_counter() - t0
    back = torch.load(out_pth, map_location="cpu", weights_only=False)
    bsd = back["model"]
    want = {**sd, **tsd}
    differ = [k for k, v in want.items() if k not in bsd or not np.array_equal(
        bsd[k].numpy().view(np.uint32), np.asarray(v).view(np.uint32))]
    bits = np.unpackbits(bsd["density_bitfield"].numpy(), bitorder="little")
    x_ok = (not differ and back["global_step"] == 0
            and bool(np.array_equal(bits.astype(bool),
                                    sd["density_grid"].reshape(-1) > 0)))
    ok &= x_ok
    lines.append(f"[reference] export in {t_export:.2f} s: {len(want)} "
                 f"tensors bit for bit equal to the imported checkpoint "
                 f"{not differ} (differ: {differ[:5]}), bitfield equal "
                 f"{'OK' if x_ok else 'FAIL'}")

    # the CLI trains the imported head and torso further
    base = [data, "--workspace", ws, "--encoder", "hash", "--asr_model",
            "deepspeech", "--preload", "1", "--train_compact_warmup",
            str(REF_HEAD_STEPS // 2)]
    for name, args, steps in (
            ("head", base + ["--iters", str(REF_HEAD_STEPS)],
             REF_HEAD_STEPS),
            ("torso", base + ["--torso", "1", "--workspace", ws + "_torso",
                              "--iters", str(REF_TORSO_STEPS)],
             REF_TORSO_STEPS)):
        rc, sec, txt = _cli(args)
        its = re.findall(r"\(([0-9.]+) it/s\)", txt)
        s_ok = (rc == 0 and "resumed at step 0" in txt
                and "training done" in txt)
        ok &= s_ok
        lines.append(
            f"[reference] CLI --encoder hash {name}: rc {rc}, {steps} steps "
            f"from the import in {sec:.1f} s wall; logged rate {its} it/s "
            f"[{smi}] {'OK' if s_ok else 'FAIL'}")
        if not s_ok:
            lines += [f"[reference]   {ln}" for ln in txt.splitlines()[-15:]]
    row = {"name": "fused_field_enc", "route": "cuda",
           "source": "lzzx_nerf_tpu_torch/csrc/fused_field.cu",
           "replaces": "lzzx_nerf_tpu/ops/fused_field.py:167",
           "launches": launches["fused_field_enc"],
           "max_abs_err": max(e["err"] for _, e in enc_checks),
           "ms": sum(r["ms"] for r in rows),
           "plain_ms": sum(r["plain_ms"] for r in rows),
           "bound_ms": sum(r["bound"] for r in rows),
           "bound_by": rows[0]["by"], "library_ms": None}
    return ok, lines, row


def _cli(args: list) -> tuple:
    """python -m lzzx_nerf_tpu_torch.cli args -> (rc, seconds, output)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lzzx_nerf_tpu_torch.cli",
                        *args], capture_output=True, text=True,
                       timeout=600)
    return r.returncode, time.perf_counter() - t0, r.stdout + r.stderr


def cli_phase(dev, root: str, smi: str, res: int = 512,
              extra: tuple = ()) -> tuple:
    """[cli]: the oracle written as a 512² dataset
    (tools/dataset.py); the CLI's head stage (CLI_HEAD[0] iterations,
    then resumed to CLI_HEAD[1], compacted from CLI_WARMUP on), the lips
    finetune to CLI_LIPS and the torso stage (CLI_TORSO) as `python -m
    lzzx_nerf_tpu_torch.cli` processes, and the head stage again with
    --fp16 0 (float32) for its rate; --test --torso in this process
    twice, once with every kernel launch held to its plain version and
    the launch counts read, once timed; then an InferenceSession serves
    the CLI's workspace -> (ok, report lines). res / extra (more CLI
    flags, e.g. --device cpu --grid_size 32): a rehearsal on the CPU."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import cli, kernels
    from lzzx_nerf_tpu_torch.config import Config
    from lzzx_nerf_tpu_torch.serving import InferenceSession
    from lzzx_nerf_tpu_torch.tools.dataset import write_synthetic_dataset

    lines = []
    t0 = time.perf_counter()
    data = write_synthetic_dataset(os.path.join(root, "oracle"), res=res,
                                   frames=32, val=2)["data"]
    ws = os.path.join(root, "trial_oracle")
    base = [data, "--workspace", ws, "--asr_model", "deepspeech",
            "--eval_interval", "2", "--ema_decay", "0.5",
            "--ema_update_interval", "10", "--train_compact_warmup",
            str(CLI_WARMUP), "--preload", "1", "--budget_frac", "0.75",
            *extra]
    lines.append(f"[cli] oracle dataset at {res}², 32 frames "
                 f"({time.perf_counter() - t0:.1f} s)")
    # the head stage computes in bf16 under --fp16 (the Config's default,
    # as in JAX); "head fp16 0" trains the same steps in float32 into a
    # workspace of its own, for the rate of each
    stages = [
        ("head", base + ["--iters", str(CLI_HEAD[0])], CLI_HEAD[0]),
        ("head fp16 0", base + ["--iters", str(CLI_HEAD[0]), "--workspace",
                                ws + "_f32", "--fp16", "0"], CLI_HEAD[0]),
        ("head resumed", base + ["--iters", str(CLI_HEAD[1])],
         CLI_HEAD[1] - CLI_HEAD[0]),
        ("lips", base + ["--iters", str(CLI_LIPS), "--finetune_lips", "1",
                         "--allow_rand_lpips", "1"], CLI_LIPS - CLI_HEAD[1]),
        ("torso", base + ["--torso", "1", "--workspace", ws + "_torso",
                          "--iters", str(CLI_TORSO)], CLI_TORSO)]
    ok = True
    rates = {}
    for name, args, steps in stages:
        rc, sec, out = _cli(args)
        its = re.findall(r"\(([0-9.]+) it/s\)", out)
        rates[name] = (its, steps / sec)
        evals = re.findall(r"\[eval\] epoch \d+: PSNR = ([0-9.]+)", out)
        s_ok = rc == 0 and ("training done" in out)
        if name == "head resumed":
            s_ok &= f"resumed at step {CLI_HEAD[0]}" in out
        ok &= s_ok
        lines.append(
            f"[cli] {name}: rc {rc}, {steps} steps in {sec:.1f} s wall "
            f"({steps / sec:.2f} steps/s with process start, data load and "
            f"evals); logged rate {its} it/s; eval PSNR {evals} "
            f"{'OK' if s_ok else 'FAIL'}")
        if not s_ok:
            lines += [f"[cli]   {ln}" for ln in out.splitlines()[-15:]]
    lines.append(
        f"[fp16] the CLI's head stage, {CLI_HEAD[0]} steps at 512², grid "
        f"128: --fp16 1 (bf16 compute, the default) logged "
        f"{rates['head'][0]} it/s ({rates['head'][1]:.2f} steps/s with "
        f"process start and evals); --fp16 0 (float32) logged "
        f"{rates['head fp16 0'][0]} it/s ({rates['head fp16 0'][1]:.2f} "
        f"steps/s) [{smi}]")
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        log_text = f.read()
    head_evals = [float(v) for v in re.findall(
        r"\[eval\] epoch \d+: PSNR = ([0-9.]+)", log_text)]
    rise = len(head_evals) >= 2 and head_evals[-1] > head_evals[0]
    ok &= rise
    lines.append(f"[cli] eval PSNR over the head and lips stages "
                 f"{head_evals}: first {head_evals[0] if head_evals else None}"
                 f", last {head_evals[-1] if head_evals else None} "
                 f"{'rises OK' if rise else 'FAIL'}")

    # --test --torso: every kernel launch held, launch counts; then timed
    test = base + ["--test", "1", "--test_train", "1", "--torso", "1"]
    field_checks, select_checks = [], []
    kernels.reset_launches()
    with kernels_held(field_checks, select_checks):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(test)
    torch_sync(dev)
    held = dict(kernels.launches)
    t1 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(test)
    torch_sync(dev)
    t_test = time.perf_counter() - t1
    out = buf.getvalue()
    f_ok = bool(field_checks) and all(e["ok"] for _, e in field_checks)
    s_ok = bool(select_checks) and all(e for _, e, _ in select_checks)
    launched = dense_launched(held)
    fps = re.findall(r"rendered (\d+) frames at ([0-9.]+) FPS", out)
    metric = re.findall(r"\[metric\] (.*)", out)
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    plan = [ln for ln in out.splitlines() if ln.startswith((
        "[INFO] traj", "[INFO] adapt", "[INFO] block", "[INFO] bucket",
        "[WARN]"))]
    t_ok = f_ok and s_ok and launched and len(pngs) == 32 and bool(fps)
    ok &= t_ok
    lines.append(
        f"[cli] --test --torso: {len(pngs)} PNGs; held run: field within "
        f"FIELD_TOL at {sum(e['ok'] for _, e in field_checks)} of "
        f"{len(field_checks)} launches (max share of tol colour "
        f"{max((e['color_share'] for _, e in field_checks), default=0):.3f}"
        f"), select equal at {sum(e for _, e, _ in select_checks)} of "
        f"{len(select_checks)}, launches {held}; timed run "
        f"{fps} frames at FPS ({t_test:.1f} s with set-up); {metric}; plan "
        f"{plan} "
        f"[{smi}] {'OK' if t_ok else 'FAIL'}")

    # the CLI's workspace served
    t1 = time.perf_counter()
    sess_lines = []
    sess = InferenceSession(cli.build_config(base), device=dev,
                            log=sess_lines.append)
    sess.load_model(data, ws)
    feats = np.load(os.path.join(data, "aud_ds.npy"))
    for _ in range(4):
        r0 = sess.rebuilds
        sess.set_audio_features(feats)
        sess.run()
        if sess.rebuilds == r0 and not sess.rebuild_pending():
            break
    sess.set_audio_features(feats)
    kernels.reset_launches()
    got = {}
    n, dt = sess.run(on_frame=lambda i, b: got.__setitem__(i, b))
    torch_sync(dev)
    launches = dict(kernels.launches)
    frame0 = got[0].reshape(sess.H, sess.W, 3).astype(np.float32) / 255.0
    gt0 = sess.ds.frame(0)["image"]
    psnr0 = float(-10 * np.log10(max(np.mean((frame0 - gt0) ** 2), 1e-12)))
    v_ok = (n == len(feats) and dense_launched(launches)
            and sess.torso is not None)
    ok &= v_ok
    lines.append(
        f"[cli] InferenceSession over the CLI's workspace (newest "
        f"checkpoint + {os.path.basename(ws)}_torso): {n} frames, "
        f"{n / dt:.2f} frames/s, launches {launches}, torso "
        f"{sess.torso is not None}, plan {sess.march_plan} K2={sess.k2} "
        f"budget={sess.budget}, frame 0 PSNR against the oracle "
        f"{psnr0:.2f} dB [{smi}] {'OK' if v_ok else 'FAIL'} "
        f"({time.perf_counter() - t1:.1f} s)")
    del sess
    torch.cuda.empty_cache()
    return ok, lines


# ---- this slice: bf16 under --fp16, --save_mesh, --asr, preprocessing

# tests/test_torch_fp16.py's step tolerance: the loss, and every
# parameter's gradient in relative L2 norm (bf16 sums rounded in other
# orders by cuBLAS / cuDNN and by the CPU)
FP16_LOSS_RTOL = 2e-5
FP16_GRAD_L2 = 3e-2
# one density chunk of --save_mesh, card vs CPU, both bf16: h = log sigma
# within two bf16 ulps of the CPU's (2^-7 of max(|h|, 1))
MESH_H_TOL = 2.0 ** -7
MESH_CHUNK = 65536
# [asr]: the seeded wav's length, and the HF-style id of the stand-in CTC
# model (a name with "deepspeech" selects 29 logits)
ASR_SECONDS = 5.0
ASR_MODEL_ID = "standin/deepspeech-ctc"
# [preprocess]: frames of the stand-in clip at 512²; the focal search's
# grid, cut in depth to three of the reference's nine focals (600..1400),
# around the stand-in's true 1100; the tracker's steps per stage: the
# focal search's focals x (2,000 + 2,500), 1,500 + 2,000, 300, 1,000
PRE_FRAMES = 100
TRACK_FOCALS = (1000, 1100, 1200)
TRACK_STEPS = {"focal": len(TRACK_FOCALS) * (2000 + 2500), "coarse": 3500,
               "light": 300, "fine": 1000}
# tests/test_face_tracking.py's recovery thresholds
TRACK_LMS_PX, TRACK_TRANS = 2.0, 0.35


def fp16_parity(dev) -> tuple:
    """One bf16 head step (the CLI's field under --fp16) at step 32, 48²,
    grid 32, 1,024 rays, S 8 on `dev` and on the CPU from one seeded init
    and the same draws: the loss within FP16_LOSS_RTOL and every gradient
    within FP16_GRAD_L2 in relative L2 norm -> (ok, report line)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.data import (SyntheticTalkingHead,
                                          two_blob_occupancy)
    from lzzx_nerf_tpu_torch.models import NeRFField
    from lzzx_nerf_tpu_torch.render import (RenderSettings,
                                            init_occupancy_state)
    from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                           make_train_step)

    G, R, N, S, STEP = 32, 48, 1024, 8, 32
    ds = SyntheticTalkingHead(num_frames=8, H=R, W=R)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=G,
                              max_steps=S, dt=2 * 3 ** 0.5 / G, num_cand=28)
    init = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(0)).state_dict()
    frame = ds.frame(0)
    g = torch.Generator().manual_seed(1)
    draws = {"inds": torch.randint(0, R * R, (N,), generator=g),
             "noise": torch.rand((N,), generator=g),
             "eye_jitter": torch.rand((1,), generator=g),
             "reg_delta": torch.rand((N * S, 3), generator=g)}

    def build(d):
        field = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64,
                          dtype=torch.bfloat16).to(d)
        field.load_state_dict(init)
        st = TrainState.create(field, HeadOptimizer(
            field.named_parameters(), 1e-2, 1e-3, 100))
        st.step = STEP
        occ = init_occupancy_state(settings, d)._replace(
            occ=two_blob_occupancy(G, d))
        step = make_train_step(field, settings, H=R, W=R,
                               intrinsics=ds.intrinsics, num_rays=N,
                               iters=100)
        b = {k: int(v) if k == "index" else
             torch.as_tensor(np.array(v), device=d) for k, v in frame.items()}
        m = step(st, occ, b, draws=draws)
        return float(m["loss"]), _grads_of(field)

    (l_cpu, g_cpu), (l_dev, g_dev) = (build(torch.device("cpu")),
                                      build(dev))
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    l2 = {n: float(np.linalg.norm(g_dev[n] - ref)
                   / max(np.linalg.norm(ref), 1e-30))
          for n, ref in g_cpu.items()}
    worst = max(l2.items(), key=lambda kv: kv[1])
    ok = loss_err <= FP16_LOSS_RTOL and worst[1] <= FP16_GRAD_L2
    return ok, (
        f"[fp16] card vs CPU, a bf16 head step {STEP} (48², grid 32, {N} "
        f"rays, S {S}): loss {l_dev:.7f} vs {l_cpu:.7f} (rel err "
        f"{loss_err:.2e}, tol {FP16_LOSS_RTOL}); largest gradient relative "
        f"L2 {worst[1]:.2e} ({worst[0]}, tol {FP16_GRAD_L2}) "
        f"{'OK' if ok else 'FAIL'}")


def _oracle_paths(root: str) -> tuple:
    """[cli]'s dataset and head workspace under root."""
    return os.path.join(root, "oracle"), os.path.join(root, "trial_oracle")


def mesh_phase(dev, root: str, smi: str, resolution: int = 256,
               extra: tuple = ()) -> tuple:
    """[mesh]: --save_mesh 1 on [cli]'s workspace (the CLI's bf16 field,
    the newest checkpoint) at `resolution`³: the density queries' seconds
    on the card, the host marcher's, the vertex and face counts; then one
    chunk of MESH_CHUNK points held against the same field on the CPU ->
    (ok, report lines). extra: more CLI flags (a CPU rehearsal)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import cli
    from lzzx_nerf_tpu_torch.data.provider import NeRFDataset
    from lzzx_nerf_tpu_torch.train.optim import HeadOptimizer
    from lzzx_nerf_tpu_torch.train.trainer import Trainer, TrainState

    data, ws = _oracle_paths(root)
    argv = [data, "--workspace", ws, "--asr_model", "deepspeech",
            "--save_mesh", "1", "--mesh_resolution", str(resolution),
            *extra]
    cfg, _ = cli.parse_args(argv)
    t0 = time.perf_counter()
    got = cli.run_save_mesh(cfg, dev)
    torch_sync(dev)
    total = time.perf_counter() - t0
    ply_ok = os.path.exists(got["path"]) and got["faces"] > 0
    lines = [
        f"[mesh] {resolution}³ = {resolution ** 3:,} density queries "
        f"(chunks of 65,536, bf16 field under --fp16) "
        f"{got['query_seconds']:.2f} s on the card, host marcher "
        f"{got['march_seconds']:.2f} s, "
        f"{total:.2f} s in all; {got['verts']} vertices, {got['faces']} "
        f"faces -> {os.path.relpath(got['path'], root)} (step "
        f"{got['step']}) [{smi}] {'OK' if ply_ok else 'FAIL'}"]

    # one chunk, card vs CPU
    ds = NeRFDataset(cfg, type="train")
    pts = torch.rand((MESH_CHUNK, 3), generator=torch.Generator()
                     .manual_seed(7)) * 2 - 1
    sig = {}
    for d in (torch.device("cpu"), dev):
        _, occ, field = cli._build_world(cfg, ds, d)
        st = TrainState.create(field, HeadOptimizer(field.named_parameters()))
        Trainer(ws).load_checkpoint(st, occ)
        b0 = ds.frame(0)
        with torch.no_grad():
            enc = field.encode_audio(torch.as_tensor(b0["auds"], device=d))
            eye = torch.as_tensor(b0["eye"], dtype=torch.float32, device=d)
            sig[d.type] = field.density(
                pts.to(d), enc, eye,
                packed=field.bake_train_tables()).sigma.cpu().double()
    h_cpu, h_dev = torch.log(sig["cpu"]), torch.log(sig[dev.type])
    dh = (h_dev - h_cpu).abs()
    tol = MESH_H_TOL * torch.clamp(h_cpu.abs(), min=1.0)
    eq = float((sig[dev.type] == sig["cpu"]).double().mean())
    c_ok = bool((dh <= tol).all()) and bool(torch.isfinite(h_dev).all())
    lines.append(
        f"[mesh] one chunk of {MESH_CHUNK} density queries, card vs CPU "
        f"(bf16 both): max |log sigma diff| {float(dh.max()):.3g} (largest "
        f"share of tol {float((dh / tol).max()):.3f}, tol 2^-7 of "
        f"max(|log sigma|, 1)), {eq:.4f} of sigmas bit-equal "
        f"{'OK' if c_ok else 'FAIL'}")
    return ply_ok and c_ok, lines


class _StandinProcessor:
    """The stand-in CTC model's processor: the samples as a [1, n]
    tensor."""

    @staticmethod
    def from_pretrained(name):
        return _StandinProcessor()

    def __call__(self, samples, sampling_rate=16000, return_tensors="pt",
                 padding=False):
        import types

        import numpy as np
        import torch

        x = torch.from_numpy(np.asarray(samples, np.float32))[None]
        return types.SimpleNamespace(input_values=x)


def _standin_ctc():
    """A stand-in of a wav2vec2-CTC model (no weights in the repository):
    a fixed-seed torch module that maps each 320-sample (20 ms) frame to
    29 logits, i.e. 29 logits at 50 Hz, on whatever device it is moved
    to."""
    import types

    import torch

    class StandinCTC(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(0)
            self.w = torch.nn.Parameter(torch.randn(320, 29, generator=g)
                                        * 0.1)

        @staticmethod
        def from_pretrained(name):
            return StandinCTC()

        def forward(self, x):
            n = x.shape[1] // 320
            return types.SimpleNamespace(
                logits=(x[0, :n * 320].reshape(n, 320) @ self.w)[None])

    mod = types.ModuleType("transformers")
    mod.AutoProcessor = _StandinProcessor
    mod.AutoModelForCTC = StandinCTC
    return mod


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _spans(idx: list) -> str:
    """[8, 9, 10, 12] -> '8-10, 12' ('none' when empty)."""
    out, start = [], None
    for k, i in enumerate(idx):
        if start is None:
            start = i
        if k + 1 == len(idx) or idx[k + 1] != i + 1:
            out.append(f"{start}-{i}" if i > start else f"{i}")
            start = None
    return ", ".join(out) or "none"


def _frames_differ(a: bytes, b: bytes, frame_bytes: int) -> list:
    n = min(len(a), len(b)) // frame_bytes
    return [i for i in range(n) if a[i * frame_bytes:(i + 1) * frame_bytes]
            != b[i * frame_bytes:(i + 1) * frame_bytes]]


def asr_phase(dev, root: str, smi: str, seconds: float = ASR_SECONDS,
              extra: tuple = ()) -> tuple:
    """[asr]: --asr 1 --asr_wav <seeded 16 kHz wav> on [cli]'s workspace
    (head + torso) through a stand-in CTC model (ASR_MODEL_ID, 29 logits
    at 50 Hz), with --asr_save_feats 1, raw frames (ffmpeg hidden). Run 1:
    the ray / stage-2 / eval budgets at the whole frame (so no rebuild
    escape fires mid-stream), eager, every kernel launch held to its plain
    version, launch counts set to 0 just before and read just after, the
    frames byte-equal to InferenceSession.run() over the saved features.
    Run 2: the Config's budgets, as a user runs --asr, eager and held, the
    frame count equal to run()'s at those budgets and the frames that
    differ from it listed (the escapes act after each chunk in run_live
    and a chunk behind in run(): ROADMAP Queue 3 item 8). Run 3: the
    Config's budgets, the session's default (captured chunks), timed,
    into the sink the machine has (raw: byte-equal to run 2) -> (ok,
    report lines, launches of run 3)."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from lzzx_nerf_tpu_torch import cli, kernels
    from lzzx_nerf_tpu_torch.serving import session as sess_mod
    from lzzx_nerf_tpu_torch.serving.streaming import RawFileSink

    data, ws = _oracle_paths(root)
    wav = os.path.join(root, "asr_speech.wav")
    pcm = np.random.default_rng(21).uniform(-0.5, 0.5, int(16000 * seconds))
    wavfile.write(wav, 16000, (pcm * 32767).astype(np.int16))
    argv_cfg = [data, "--workspace", ws, "--asr", "1", "--asr_wav", wav,
                "--asr_model", ASR_MODEL_ID, "--asr_save_feats", "1",
                *extra]
    argv_whole = argv_cfg + ["--budget_frac", "1.0", "--infer_stage2_frac",
                             "1.0", "--infer_eval_frac", "1.0"]
    lines, ok = [], True
    standin = _standin_ctc()
    orig_init = sess_mod.InferenceSession.__init__

    def eager_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        self.graph = False

    def held_run(argv):
        """An eager raw run with every launch held -> (result, seconds,
        launches, field checks, select checks, held ok, frame bytes)."""
        cfg, _ = cli.parse_args(argv)
        field_checks, select_checks = [], []
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            stack.enter_context(_sys_module("transformers", standin))
            stack.enter_context(_patched(cli.shutil, "which",
                                         lambda n: None))
            stack.enter_context(_patched(sess_mod.InferenceSession,
                                         "__init__", eager_init))
            kernels.reset_launches()
            with kernels_held(field_checks, select_checks):
                with contextlib.redirect_stdout(io.StringIO()):
                    res = cli.run_asr_live(cfg, dev)
            torch_sync(dev)
            launches = dict(kernels.launches)
        sec = time.perf_counter() - t0
        held_ok = (bool(field_checks) and all(e["ok"] for _, e in field_checks)
                   and bool(select_checks)
                   and all(e for _, e, _ in select_checks)
                   and dense_launched(launches))
        with open(res["out"], "rb") as f:
            out = f.read()
        return res, sec, launches, field_checks, select_checks, held_ok, out

    def offline(argv, feats, name):
        """InferenceSession.run() over feats -> (frames, bytes, frame
        bytes)."""
        cfg, _ = cli.parse_args(argv)
        sess = sess_mod.InferenceSession(cfg.replace(asr=False), device=dev,
                                         log=lambda m: None)
        sess.load_model(data, ws)
        sess.set_audio_features(feats)
        path = os.path.join(root, name)
        n, _ = sess.run(RawFileSink(path))
        with open(path, "rb") as f:
            out = f.read()
        os.remove(path)
        fb = sess.H * sess.W * 3
        del sess
        torch.cuda.empty_cache()
        return n, out, fb

    def held_text(fc, sc):
        return (
            f"field within FIELD_TOL at {sum(e['ok'] for _, e in fc)} of "
            f"{len(fc)} launches (max share of tol colour "
            f"{max((e['color_share'] for _, e in fc), default=0):.3f}, sigma "
            f"{max((e['sigma_share'] for _, e in fc), default=0):.3f}), "
            f"select equal at {sum(e for _, e, _ in sc)} of {len(sc)}")

    # run 1: whole-frame budgets, eager, held, byte-equal to run()
    held, t_held, held_launches, fc, sc, h_ok, live_bytes = held_run(
        argv_whole)
    feats = np.load(held["feats"])
    n_ref, ref_bytes, frame_bytes = offline(argv_whole, feats, "asr_run.raw")
    same = live_bytes == ref_bytes and n_ref == held["frames"]
    r_ok = (h_ok and same and held["frames"] > 0
            and feats.shape == (held["frames"], 16, 29))
    ok &= r_ok
    lines.append(
        f"[asr] stand-in CTC model ({ASR_MODEL_ID}: 29 logits at 50 Hz "
        f"from a fixed-seed map, not a trained ASR) over a seeded "
        f"{seconds:.0f} s 16 kHz wav, budgets at the whole frame, eager "
        f"run: {held['frames']} frames in {t_held:.1f} s with every launch "
        f"held; {held_text(fc, sc)}; launches {held_launches}; "
        f"--asr_save_feats {os.path.basename(held['feats'])} {feats.shape};"
        f" raw frames {len(live_bytes) // frame_bytes} byte-equal to run() "
        f"over the saved features {same} {'OK' if r_ok else 'FAIL'}")
    del live_bytes, ref_bytes

    # run 2: the Config's budgets, eager, held, against run() there
    cfg_run, t_cfg, cfg_launches, fc, sc, c_ok, cfg_bytes = held_run(
        argv_cfg)
    feats_c = np.load(cfg_run["feats"])
    n_c, ref_c, _ = offline(argv_cfg, feats_c, "asr_run_cfg.raw")
    differ = _frames_differ(cfg_bytes, ref_c, frame_bytes)
    c_ok = (c_ok and n_c == cfg_run["frames"] == held["frames"]
            and len(cfg_bytes) == len(ref_c) == n_c * frame_bytes
            and np.array_equal(feats_c, feats))
    ok &= c_ok
    lines.append(
        f"[asr] the Config's budgets (as a user runs --asr), eager run: "
        f"{cfg_run['frames']} frames in {t_cfg:.1f} s with every launch "
        f"held; {held_text(fc, sc)}; launches {cfg_launches}; features "
        f"equal to run 1's; run() over them {n_c} frames; frames that "
        f"differ from run(): {_spans(differ)} ({len(differ)} of {n_c}: "
        f"run_live's escapes act after each chunk, run()'s a chunk behind;"
        f" ROADMAP Queue 3 item 8) {'OK' if c_ok else 'FAIL'}")
    del ref_c

    # run 3: the Config's budgets, the default path (captured), timed
    cfg, _ = cli.parse_args(argv_cfg)
    t0 = time.perf_counter()
    with _sys_module("transformers", standin):
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            timed = cli.run_asr_live(cfg, dev)
        torch_sync(dev)
        launches = dict(kernels.launches)
    t_timed = time.perf_counter() - t0
    same_eager = "not compared (mp4)"
    t_ok = (timed["frames"] == cfg_run["frames"]
            and dense_launched(launches))
    if timed["out"].endswith(".raw"):
        with open(timed["out"], "rb") as f:
            eq = f.read() == cfg_bytes
        same_eager = f"byte-equal to run 2's {eq}"
        t_ok &= eq
    ok &= t_ok
    lines.append(
        f"[asr] the Config's budgets, default run (captured chunks) into "
        f"{os.path.basename(timed['out'])}: {timed['frames']} frames, "
        f"{timed['frames'] / timed['seconds']:.2f} frames/s in run_live "
        f"({timed['seconds']:.2f} s; the wav is not paced), "
        f"{t_timed:.1f} s with the session's set-up; {same_eager}; "
        f"launches {launches} [{smi}] {'OK' if t_ok else 'FAIL'}")
    del cfg_bytes
    torch.cuda.empty_cache()
    return ok, lines, launches


@contextlib.contextmanager
def _sys_module(name, module):
    old = sys.modules.get(name)
    sys.modules[name] = module
    try:
        yield
    finally:
        if old is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = old


def _standin_hubert():
    """A stand-in of HuBERT (no weights in the repository): a fixed-seed
    map of each 400-sample window at stride 320 to 1,024 features."""
    import types

    import torch

    class StandinHubert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(0)
            self.w = torch.nn.Parameter(torch.randn(400, 1024, generator=g)
                                        * 0.05)

        @staticmethod
        def from_pretrained(name):
            return StandinHubert()

        def forward(self, x):
            frames = x[0].unfold(0, 400, 320)
            return types.SimpleNamespace(
                last_hidden_state=(frames @ self.w)[None])

    mod = types.ModuleType("transformers")
    mod.HubertModel = StandinHubert
    mod.Wav2Vec2Processor = _StandinProcessor
    return mod


def _process(args: list, env: dict) -> tuple:
    """python -m lzzx_nerf_tpu_torch.preprocess.process args -> (rc,
    seconds, output)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "lzzx_nerf_tpu_torch.preprocess.process", *args],
                       capture_output=True, text=True, timeout=900,
                       env={**os.environ, **env})
    return r.returncode, time.perf_counter() - t0, r.stdout + r.stderr


def _track_cut(video: str, env: dict, device_flag: tuple) -> tuple:
    """Task 8 through process.run_pipeline in this process, its focal
    search over TRACK_FOCALS (a depth cut: fit_focal's grid bound for the
    call) -> (rc, seconds, output)."""
    import functools
    import traceback

    from lzzx_nerf_tpu_torch.preprocess import face_tracking as ft
    from lzzx_nerf_tpu_torch.preprocess import process

    t0 = time.perf_counter()
    out, rc = [], 0
    fit_focal, old_env = ft.fit_focal, dict(os.environ)
    ft.fit_focal = functools.partial(fit_focal, focal_range=TRACK_FOCALS)
    os.environ.update(env)
    try:
        process.run_pipeline(video, 8, device="cpu" if device_flag else None,
                             log=out.append)
    except Exception:
        rc = 1
        out += traceback.format_exc().splitlines()
    finally:
        ft.fit_focal = fit_focal
        os.environ.clear()
        os.environ.update(old_env)
    return rc, time.perf_counter() - t0, "\n".join(out)


def preprocess_phase(dev, root: str, smi: str, frames: int = PRE_FRAMES,
                     res: int = 512, device_flag: tuple = ()) -> tuple:
    """[preprocess]: the stand-in identity of tools/synthetic_face.py (BFM
    widths: 34,650 vertices, id 100, exp 79, tex 100; `frames` frames at
    `res`², their .lms, a TorchScript parser); tasks 4, 5, 6 and 9 as
    `python -m lzzx_nerf_tpu_torch.preprocess.process` processes on the
    card, task 8 through the same entry (process.run_pipeline) in this
    process with the focal search cut to TRACK_FOCALS, tasks 1 and 3 on a
    clip made from the frames when ffmpeg is on the PATH, task 2 in this
    process through a stand-in HuBERT; the
    tracker's stage seconds, steps/s and peak memory, its recovery of the
    ground truth, and the written dataset loaded by the port's provider ->
    (ok, report lines). device_flag: ("--device", "cpu") to rehearse."""
    import importlib.util

    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.config import Config
    from lzzx_nerf_tpu_torch.data.provider import NeRFDataset
    from lzzx_nerf_tpu_torch.preprocess import face_tracking as ft
    from lzzx_nerf_tpu_torch.preprocess import process
    from lzzx_nerf_tpu_torch.tools import synthetic_face as sf

    lines, ok = [], True
    t0 = time.perf_counter()
    bfm = os.path.join(root, "3DMM")
    sizes = sf.write_bfm_assets(bfm)
    base = os.path.join(root, "pre_id")
    got = sf.write_frames(base, bfm, frames=frames, res=res, device=dev)
    video = os.path.join(base, "clip.mp4")
    lines.append(
        f"[preprocess] stand-in identity (tools/synthetic_face.py, not a "
        f"BFM and not a real face): {sizes}; {frames} frames at {res}² "
        f"rendered from seeded parameters, .lms with 0.5 px noise, a "
        f"TorchScript colour parser ({time.perf_counter() - t0:.1f} s)")

    # tasks 1-3: ffmpeg's, and task 2's models
    ran = []
    wav_for_2 = os.path.join(root, "pre_speech.wav")
    from scipy.io import wavfile

    pcm = np.random.default_rng(5).uniform(-0.5, 0.5, 16000 * 4)
    wavfile.write(wav_for_2, 16000, (pcm * 32767).astype(np.int16))
    if shutil.which("ffmpeg"):
        vdir = os.path.join(root, "pre_video")
        os.makedirs(vdir, exist_ok=True)
        clip = os.path.join(vdir, "clip.mp4")
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-framerate",
                        "25", "-i", os.path.join(got["ori_dir"], "%d.jpg"),
                        "-i", wav_for_2, "-shortest", "-c:v", "libx264",
                        "-pix_fmt", "yuv420p", clip], check=True)
        for task in (1, 3):
            rc, sec, out = _process([clip, "--task", str(task),
                                     *device_flag], {})
            t_ok = rc == 0
            ok &= t_ok
            ran.append(f"task {task} rc {rc} {sec:.1f} s")
        n_imgs = len([f for f in os.listdir(os.path.join(vdir, "ori_imgs"))
                      if f.endswith(".jpg")])
        ran.append(f"aud.wav {os.path.getsize(os.path.join(vdir, 'aud.wav'))}"
                   f" bytes, {n_imgs} frames decoded")
        wav_for_2 = os.path.join(vdir, "aud.wav")
    else:
        ran.append("tasks 1 and 3 not run: no ffmpeg on the PATH")
    t1 = time.perf_counter()
    with _sys_module("transformers", _standin_hubert()):
        out2 = process.extract_audio_features(wav_for_2, "hubert",
                                              device=dev)
    hu = np.load(out2)
    ran.append(f"task 2 through a stand-in HuBERT (fixed-seed, not "
               f"trained): {os.path.basename(out2)} {hu.shape} "
               f"({time.perf_counter() - t1:.1f} s)")
    lines.append(f"[preprocess] {'; '.join(ran)}")

    # tasks 4-9 as processes on the card; task 7 (face_alignment) is
    # stood in for by the .lms written with the frames
    env = {"LZZX_PARSER_TS": got["parser"], "LZZX_BFM_DIR": bfm}
    fa = importlib.util.find_spec("face_alignment") is not None
    stage_s = {}
    for task in (4, 5, 6, 8, 9):
        if task == 8:
            rc, sec, out = _track_cut(video, env, device_flag)
        else:
            rc, sec, out = _process([video, "--task", str(task),
                                     *device_flag], env)
        t_ok = rc == 0
        ok &= t_ok
        done = re.findall(r"\[task \d\] done in .*", out)
        if task == 8:
            for name, s in re.findall(r"\[task 8\] (\w+): ([0-9.]+) s", out):
                stage_s[name] = float(s)
        how = "in this process" if task == 8 else "with process start"
        lines.append(f"[preprocess] task {task}: rc {rc}, {sec:.1f} s {how}"
                     f"; {done} {'OK' if t_ok else 'FAIL'}")
        if not t_ok:
            lines += [f"[preprocess]   {ln}" for ln in out.splitlines()[-12:]]
    lines.append(
        f"[preprocess] task 7: face_alignment "
        f"{'present' if fa else 'absent'}; the stand-in .lms files stand in "
        "for its output")
    rates = {k: f"{TRACK_STEPS[k] / v:.1f}" for k, v in stage_s.items()
             if v > 0}
    lines.append(
        f"[preprocess] tracker stages (s): {stage_s}; steps/s {rates} "
        f"(steps per stage {TRACK_STEPS}; the focals {TRACK_FOCALS}, three "
        f"of the reference's nine; its iterations and frames not cut) "
        f"[{smi}]")

    # the tracker against the ground truth
    gt = got["gt"]
    d = np.load(os.path.join(base, "track_params.npz"))
    model = ft.Face3DMM.load(bfm, device="cpu")
    cxy = (res / 2.0, res / 2.0)
    lms = torch.as_tensor(np.stack([np.loadtxt(os.path.join(
        got["ori_dir"], f"{i}.lms")) for i in range(frames)]),
        dtype=torch.float32)
    q = {k: torch.as_tensor(d[k]) for k in d.files}
    f = q["focal"].reshape(())
    pr = ft.forward_transform(
        model.landmarks_3d(q["id"].expand(frames, -1), q["exp"], q["euler"],
                           q["trans"], f, cxy),
        q["euler"], q["trans"], f, cxy)[..., :2]
    err = float(torch.sqrt(torch.mean((pr[:, 17:] - lms[:, 17:]) ** 2)))
    terr = float(np.abs(d["trans"] - gt["trans"]).max())
    rerr = float((ft.euler2rot(q["euler"]) - ft.euler2rot(torch.as_tensor(
        gt["euler"], dtype=torch.float32))).abs().max())
    g_ok = err < TRACK_LMS_PX and terr < TRACK_TRANS
    ok &= g_ok
    lines.append(
        f"[preprocess] tracked against the ground truth: focal "
        f"{float(f):.0f} (true {float(gt['focal']):.0f}), inner-landmark "
        f"reprojection error {err:.3f} px (threshold {TRACK_LMS_PX}), "
        f"translation error {terr:.4f} (threshold {TRACK_TRANS}), rotation "
        f"entries within {rerr:.4f} {'OK' if g_ok else 'FAIL'}")

    # the written dataset through the port's provider
    cfg = Config(path=base, asr_model="deepspeech")
    ds_t = NeRFDataset(cfg, type="train")
    ds_v = NeRFDataset(cfg, type="val")
    b0 = ds_t.frame(0)
    p_ok = (len(ds_t.poses) + len(ds_v.poses) == frames
            and b0["image"].shape == (res, res, 3)
            and bool(np.isfinite(ds_t.poses).all()))
    ok &= p_ok
    lines.append(
        f"[preprocess] the written dataset loads through the port's "
        f"provider: {len(ds_t.poses)} train + {len(ds_v.poses)} val frames, "
        f"{ds_t.H}x{ds_t.W}, intrinsics "
        f"{[round(float(v), 2) for v in ds_t.intrinsics]}, frame 0 image "
        f"{b0['image'].shape} {'OK' if p_ok else 'FAIL'}")
    return ok, lines


def _syncs(fn) -> list:
    """The host synchronisations fn makes (torch's sync debug mode), as
    the file:line of the Python call that made each."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in rec
            if "synchroniz" in str(w.message)]


def train_production(dev) -> tuple:
    """The production point through the entry point's HeadRun -> (ok,
    report lines, summary dict)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.tools.train_production import HeadRun

    lines = []
    t0 = time.perf_counter()
    run = HeadRun(res=512, grid=128, frames=32, num_rays=65536,
                  budget_frac=0.75, warmup=TRAIN_WARMUP,
                  head_iters=30000, eval_res=256, seed=0, device=dev,
                  log=lambda m: lines.append(f"[train] {m}"))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    psnr0, per0 = run.eval_psnr()

    def timed(fn):
        torch.cuda.synchronize()
        a = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - a

    losses, t_step = [], {"full": [], "compacted": []}
    t_ref, peak, n_act = [], {}, []
    for it in range(TRAIN_WARMUP + TRAIN_COMPACT):
        if it % 16 == 0:
            _, dt = timed(lambda: run.refresh_grid(it))
            t_ref.append(dt)
        path = "compacted" if it >= TRAIN_WARMUP else "full"
        if it in (TRAIN_WARMUP - 1, TRAIN_WARMUP + 1):
            torch.cuda.reset_peak_memory_stats(dev)
        m, dt = timed(lambda: run.train_step(it))
        if it in (TRAIN_WARMUP - 1, TRAIN_WARMUP + 1):
            peak[path] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        t_step[path].append(dt)
        losses.append(m["loss"])
        if path == "compacted":
            n_act.append(m["n_active"])
    it = TRAIN_WARMUP + TRAIN_COMPACT
    # three steps of each path, none a regulariser step, after one empty
    # call (so a sync made by switching the debug mode on the first time
    # is counted apart)
    syncs = {"none": _syncs(lambda: None)}
    syncs.update({p: _syncs(lambda: [run.train_step(it + k, p == "compacted")
                                for k in (1, 2, 3)])
             for p in ("full", "compacted")})
    skipped, _ = run.opt.poll(it)
    losses = torch.stack(losses).cpu().numpy()
    n_act = torch.stack(n_act).cpu().numpy()
    psnr1, per1 = run.eval_psnr()
    first, last = float(losses[:30].mean()), float(losses[-30:].mean())
    ok = (bool(np.isfinite(losses).all()) and last < 0.8 * first
          and psnr1 > psnr0 and skipped == 0)

    def rate(ts):
        # the first steps of each path warm up allocators and libraries
        return 1.0 / float(np.median(ts[5:]))

    lines.append(
        f"[train] production point 512², grid 128, S 16, 65,536 rays, "
        f"budget {run.budget} (setup {t_setup:.1f} s): full path "
        f"{rate(t_step['full']):.2f} steps/s (median "
        f"{1e3 * np.median(t_step['full'][5:]):.2f} ms over "
        f"{len(t_step['full']) - 5}), compacted "
        f"{rate(t_step['compacted']):.2f} steps/s (median "
        f"{1e3 * np.median(t_step['compacted'][5:]):.2f} ms over "
        f"{len(t_step['compacted']) - 5}); grid refresh (grid 128) median "
        f"{np.median(t_ref[1:]):.4f} s over {len(t_ref) - 1} (first "
        f"{t_ref[0]:.3f} s); peak memory full {peak['full']:.2f} GiB, "
        f"compacted {peak['compacted']:.2f} GiB; n_active max "
        f"{int(n_act.max())} mean {float(n_act.mean()):.0f} of budget "
        f"{run.budget}; grad_notfinite {skipped}; host syncs over 3 steps: "
        f"full {len(syncs['full'])} {sorted(set(syncs['full']))}, "
        f"compacted {len(syncs['compacted'])} "
        f"{sorted(set(syncs['compacted']))} (the empty call before them: "
        f"{len(syncs['none'])})")
    lines.append(
        f"[train] loss first 30 steps {first:.6f}, last 30 {last:.6f} "
        f"(ratio {last / first:.3f}, must be < 0.8); eval PSNR 256² over "
        f"frames {run.eval_frames}: {psnr0:.2f} dB {per0} -> {psnr1:.2f} "
        f"dB {per1} {'OK' if ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")
    return ok, lines, run


def train_profile(step, what: str) -> list:
    """torch.profiler's top-10 device kernels of one training step and the
    share of the table-gradient scatter (index_add / scatter kernels);
    step(k) runs a step (k = 0 warms up, k = 1 is profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(1)
        torch.cuda.synchronize()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total = sum(dev_us(e) for e in kern)
    if not kern or total <= 0:
        return ["[profile] torch.profiler recorded no device time"]
    scatter = ("indexFunc", "index_add", "scatter_add", "scatter_gather")
    sc = sum(dev_us(e) for e in kern if any(k in e.key for k in scatter))
    lines = [f"[profile] {what}: {total / 1e3:.3f} device ms "
             f"over {sum(e.count for e in kern)} kernels; table-gradient "
             f"scatter (index_add / scatter kernels) {sc / 1e3:.3f} ms, "
             f"share {sc / total:.3f}"]
    for e in sorted(kern, key=dev_us, reverse=True)[:10]:
        lines.append(f"[profile]   {dev_us(e) / 1e3:8.3f} ms "
                     f"{dev_us(e) / total:6.3f} x{e.count:<4d} "
                     f"{e.key[:110]}")

    # the autograd nodes (backward) by the device time of what they launch
    def incl_us(e):
        for attr in ("device_time_total", "cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    nodes = [e for e in prof.key_averages()
             if e.key.endswith("Backward0") or e.key.endswith("Backward1")]
    lines.append("[profile] backward nodes by device time (inclusive):")
    for e in sorted(nodes, key=incl_us, reverse=True)[:8]:
        lines.append(f"[profile]   {incl_us(e) / 1e3:8.3f} ms "
                     f"{incl_us(e) / total:6.3f} x{e.count:<4d} {e.key}")
    return lines


# ---- this slice: patch LPIPS, the staged training composite, parallel/

# the staged step at the production point (the CLI's stage-2 budget from
# the Config's train_stage2_frac 0.34 of the 49,152-ray budget), timed in
# turns against the single-pass compacted step
STAGE_SPLIT, STAGE2_FRAC = 8, 0.34
STAGE_STEPS = 15
# the CLI runs of [patch] and [parallel]: head steps on [cli]'s dataset
PAR_STEPS = 100


def _world48():
    """The 48² parity world of [train]: the oracle's frame 0, grid 32, S 8,
    the seeded field's state and the two-blob occupancy's settings."""
    import torch

    from lzzx_nerf_tpu_torch.data import SyntheticTalkingHead
    from lzzx_nerf_tpu_torch.models import NeRFField
    from lzzx_nerf_tpu_torch.render import RenderSettings

    G, R = 32, 48
    ds = SyntheticTalkingHead(num_frames=8, H=R, W=R)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=G,
                              max_steps=8, dt=2 * 3 ** 0.5 / G, num_cand=28)
    init = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).init_params(
        torch.Generator().manual_seed(0)).state_dict()
    return ds, settings, init, ds.frame(0)


def _step48(d, ds, settings, init, frame, draws, step, **kw) -> tuple:
    """One head step of the 48² world on device d -> (metrics as Python
    numbers, gradients)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.data import two_blob_occupancy
    from lzzx_nerf_tpu_torch.models import NeRFField
    from lzzx_nerf_tpu_torch.render import init_occupancy_state
    from lzzx_nerf_tpu_torch.train import (HeadOptimizer, TrainState,
                                           make_train_step)

    field = NeRFField(audio_in_dim=ds.audio_dim, ind_num=64).to(d)
    field.load_state_dict(init)
    st = TrainState.create(field, HeadOptimizer(
        field.named_parameters(), 1e-2, 1e-3, 100))
    st.step = step
    occ = init_occupancy_state(settings, d)._replace(
        occ=two_blob_occupancy(settings.grid_size, d))
    fn = make_train_step(field, settings, H=ds.H, W=ds.W,
                         intrinsics=ds.intrinsics, iters=100, **kw)
    b = {k: int(v) if k == "index" else
         torch.as_tensor(np.array(v), device=d) for k, v in frame.items()}
    m = fn(st, occ, b, draws=draws)
    return ({k: (v.item() if torch.is_tensor(v) else v)
             for k, v in m.items()}, _grads_of(field))


def stage_parity(dev) -> tuple:
    """One staged compacted step at step 32 (48², grid 32, 1,024 rays,
    ray budget 1,024, train_stage_split 4) on `dev` and on the CPU from
    one seeded init and the same draws, at a stage-2 budget of 64 (the
    survivors overflow it and end at the split) and 1,024 (every survivor
    fits): the loss and gradients to [train]'s tolerances, n_stage2 and
    n_stage2_over equal -> (ok, report lines)."""
    import torch

    ds, settings, init, frame = _world48()
    N, S = 1024, settings.max_steps
    g = torch.Generator().manual_seed(5)
    draws = {"inds": torch.randint(0, ds.H * ds.W, (N,), generator=g),
             "noise": torch.rand((N,), generator=g),
             "eye_jitter": torch.rand((1,), generator=g),
             "reg_delta": torch.rand((N * S, 3), generator=g)}
    ok, lines = True, []
    for stage2 in (64, 1024):
        seen = {}

        def build(d):
            m, grads = _step48(d, ds, settings, init, frame, draws, 32,
                               num_rays=N, train_budget=N,
                               train_stage_split=4,
                               train_stage2_budget=stage2)
            seen[d.type] = (m["n_stage2"], m["n_stage2_over"])
            return m["loss"], grads

        p_ok, line = _card_vs_cpu(
            dev, build, f"[train] card vs CPU, staged compacted step 32 "
            f"(48², grid 32, {N} rays, split 4, stage-2 budget {stage2})")
        same = seen["cpu"] == seen[dev.type]
        over = seen["cpu"][1] > 0 if stage2 == 64 else seen["cpu"][1] <= 0
        ok &= p_ok and same and over
        lines.append(f"{line}; n_stage2, over: card {seen[dev.type]}, CPU "
                     f"{seen['cpu']} {'OK' if same and over else 'FAIL'}")
    return ok, lines


def patch_parity(dev) -> tuple:
    """One patch step at step 32 (48², grid 32, patch_size 32: 1,024 rays
    in one patch, 0.1 x LPIPS on the fixed-seed backbone) on `dev` and on
    the CPU from one seeded init and the same draws -> (ok, report line).
    The tables are drawn in ±0.5, as [torso]'s are: at the ±1e-4 init a
    hidden unit's pre-activation can sit within rounding of zero, and the
    card and the CPU then take the ReLU's two branches for it (one unit
    of unc_net, 33 of its 1,152 input weights, did at seed 6)."""
    import torch

    from lzzx_nerf_tpu_torch.train import lpips as lpips_mod
    from lzzx_nerf_tpu_torch.utils.rays import patch_inds

    ds, settings, init, frame = _world48()
    N, S = 1024, settings.max_steps
    g = torch.Generator().manual_seed(6)
    init = {k: ((torch.rand(v.shape, generator=g) - 0.5)
                if k.startswith("encoder_") else v)
            for k, v in init.items()}
    draws = {"inds": patch_inds(ds.H, ds.W, N, 32, g),
             "noise": torch.rand((N,), generator=g),
             "eye_jitter": torch.rand((1,), generator=g),
             "reg_delta": torch.rand((N * S, 3), generator=g)}

    def build(d):
        m, grads = _step48(d, ds, settings, init, frame, draws, 32,
                           num_rays=N, patch_size=32,
                           lpips_params=lpips_mod.random_params(device=d))
        return m["loss"], grads

    return _card_vs_cpu(dev, build, f"[patch] card vs CPU, patch step 32 "
                        f"(48², grid 32, one 32² patch, LPIPS on the "
                        f"fixed-seed backbone)")


def stage_production(run, dev, smi: str) -> tuple:
    """The staged compacted step against the single-pass one at the
    production point, over the [train] run's field and grid (512², grid
    128, S 16, 65,536 rays, budget 49,152): STAGE_STEPS steps of each in
    four alternating turns, split STAGE_SPLIT with the CLI's stage-2 budget
    from STAGE2_FRAC -> (ok, report lines)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.train import make_train_step

    stage2 = max(1024, int(run.budget * STAGE2_FRAC) // 1024 * 1024)
    staged = make_train_step(run.field, run.settings,
                             train_budget=run.budget,
                             train_stage_split=STAGE_SPLIT,
                             train_stage2_budget=stage2, **run.common)
    fns = {0: run.step_compact, STAGE_SPLIT: staged}
    t_step = {0: [], STAGE_SPLIT: []}
    peak, n2, losses = {}, [], {0: [], STAGE_SPLIT: []}
    it = 10_000
    for turn in range(4):
        split = STAGE_SPLIT if turn % 2 else 0
        torch.cuda.reset_peak_memory_stats(dev)
        for k in range(STAGE_STEPS):
            torch.cuda.synchronize()
            a = time.perf_counter()
            m = fns[split](run.state, run.occ,
                           run.frames[it % len(run.frames)], run.gen)
            torch.cuda.synchronize()
            t_step[split].append(time.perf_counter() - a)
            losses[split].append(float(m["loss"]))
            if split:
                n2.append(int(m["n_stage2"]))
            it += 1
        peak[split] = max(peak.get(split, 0.0),
                          torch.cuda.max_memory_allocated(dev) / 2 ** 30)

    def rate(ts):
        # the first steps of each turn warm up
        return 1.0 / float(np.median(ts))

    n2 = np.asarray(n2)
    ok = all(np.isfinite(v).all() for v in losses.values())
    r0, r8 = rate(t_step[0]), rate(t_step[STAGE_SPLIT])
    return ok, [
        f"[train] staged vs single-pass compacted step at the production "
        f"point (512², grid 128, S 16, 65,536 rays, budget {run.budget}), "
        f"{STAGE_STEPS} steps x 2 turns each, alternating: split 0 "
        f"{r0:.2f} steps/s (median {1e3 / r0:.2f} ms), split "
        f"{STAGE_SPLIT} (stage-2 budget {stage2}) {r8:.2f} steps/s (median "
        f"{1e3 / r8:.2f} ms), ratio {r8 / r0:.3f}; n_stage2 max "
        f"{int(n2.max())} mean {float(n2.mean()):.0f} of {stage2}, "
        f"{int((n2 > stage2).sum())} of {len(n2)} steps over; peak memory "
        f"split 0 {peak[0]:.2f} GiB, split {STAGE_SPLIT} "
        f"{peak[STAGE_SPLIT]:.2f} GiB [{smi}] {'OK' if ok else 'FAIL'}"]


@contextlib.contextmanager
def _group_of_one(dev):
    """A torch.distributed group of this process alone (NCCL on the card,
    gloo on the CPU), destroyed on exit."""
    import torch.distributed as dist

    from lzzx_nerf_tpu_torch.parallel.distributed import backend_for

    dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def dp_production(run, dev, smi: str) -> tuple:
    """The data-parallel compacted step at world size 1 (NCCL, a group of
    one: the gather of the per-ray outputs, the summed gradients, every
    collective of the path) against the plain compacted step at the
    production point, over the [train] run's field: STAGE_STEPS steps of
    each in four alternating turns, then torch.profiler's top kernels of
    one data-parallel step -> (ok, report lines)."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch.parallel import data_sharding, make_mesh
    from lzzx_nerf_tpu_torch.train import make_train_step

    lines = []
    with _group_of_one(dev) as group:
        sh = data_sharding(make_mesh("data", [dev], group=group))
        dp = make_train_step(run.field, run.settings,
                             train_budget=run.budget, data_sharding=sh,
                             **run.common)
        fns = {"plain": run.step_compact, "dp": dp}
        t_step = {"plain": [], "dp": []}
        it = 20_000
        for turn in range(4):
            name = "dp" if turn % 2 else "plain"
            for k in range(STAGE_STEPS):
                torch.cuda.synchronize()
                a = time.perf_counter()
                m = fns[name](run.state, run.occ,
                              run.frames[it % len(run.frames)], run.gen)
                torch.cuda.synchronize()
                t_step[name].append(time.perf_counter() - a)
                it += 1
        ok = bool(np.isfinite(float(m["loss"])))
        r = {k: 1.0 / float(np.median(v)) for k, v in t_step.items()}
        lines.append(
            f"[train] data-parallel compacted step at world size 1 (NCCL) "
            f"against the plain compacted step at the production point, "
            f"{STAGE_STEPS} steps x 2 turns each, alternating: plain "
            f"{r['plain']:.2f} steps/s (median {1e3 / r['plain']:.2f} ms), "
            f"data-parallel {r['dp']:.2f} steps/s (median "
            f"{1e3 / r['dp']:.2f} ms), ratio {r['dp'] / r['plain']:.3f} "
            f"[{smi}] {'OK' if ok else 'FAIL'}")
        lines += train_profile(
            lambda k: dp(run.state, run.occ, run.frames[k], run.gen),
            "one data-parallel compacted step (world size 1)")
    return ok, lines


def _ckpt_updates(ws: str) -> dict:
    """The newest checkpoint's parameters minus its EMA (the initial
    values while the EMA has not moved), per parameter, as numpy."""
    from lzzx_nerf_tpu_torch.serving.state_io import (params_from_jax,
                                                      read_checkpoint)

    ck = read_checkpoint(os.path.join(ws, "checkpoints"))
    p = params_from_jax(ck["state"]["params"]["params"])
    e = params_from_jax(ck["state"]["ema_params"])
    return {k: (p[k] - e[k]).numpy() for k in p}, int(ck["state"]["step"])


def _head_steps_spec(device: str) -> dict:
    """parallel.steps.head_steps' spec for one compacted step at step 32
    of the 48² world (1,024 rays, budget 1,024: 512 slots a rank at world
    size 2, which no shard overflows), draws from a seeded generator."""
    import numpy as np
    import torch

    ds, settings, init, frame = _world48()
    N, S = 1024, settings.max_steps
    g = torch.Generator().manual_seed(7)
    draws = {"inds": torch.randint(0, ds.H * ds.W, (N,), generator=g),
             "noise": torch.rand((N,), generator=g),
             "eye_jitter": torch.rand((1,), generator=g),
             "reg_delta": torch.rand((N * S, 3), generator=g)}
    from lzzx_nerf_tpu_torch.data import two_blob_occupancy
    from lzzx_nerf_tpu_torch.render import init_occupancy_state

    occ = init_occupancy_state(settings)._replace(
        occ=two_blob_occupancy(settings.grid_size))
    return {"device": device,
            "field": dict(audio_in_dim=ds.audio_dim, ind_num=64),
            "state": {k: v.numpy() for k, v in init.items()},
            "settings": dict(bound=1.0, cascade=1,
                             grid_size=settings.grid_size, max_steps=S,
                             dt=settings.dt, num_cand=28),
            "occ": {k: np.asarray(v) for k, v in occ._asdict().items()},
            "batch": frame,
            "common": dict(H=ds.H, W=ds.W, intrinsics=ds.intrinsics,
                           num_rays=N, iters=100),
            "cases": [{"step": 32, "kw": {"train_budget": N},
                       "draws": {k: v.numpy() for k, v in draws.items()}}]}


def parallel_phase(dev, root: str, smi: str, live: dict) -> tuple:
    """[patch] and [parallel] -> (ok, report lines, the frame-parallel
    captured run's launch counts). On [cli]'s 512² dataset, PAR_STEPS head
    steps each as `python -m lzzx_nerf_tpu_torch.cli` processes: plain,
    with --patch_size 32 --allow_rand_lpips 1, and with --data_parallel 1
    (a group of one over NCCL), whose checkpoint is held to the plain
    one's; --data_parallel 2 on this one-card machine must exit with the
    JAX CLI's message. One compacted data-parallel step at world size 1 on
    the card against world size 2 over gloo on the CPU (two processes).
    Serving: infer_data_parallel 2 clamps to one device and serves
    [live]'s bytes; then the frame-parallel program over [dev, dev] (the
    session's devices= seam): its frames byte-equal to [live]'s, one eager
    chunk with every launch held to its plain version, the captured run's
    launches counted per replica (both kernels on each), frames/s."""
    import numpy as np
    import torch

    from lzzx_nerf_tpu_torch import kernels
    from lzzx_nerf_tpu_torch.parallel.distributed import launch
    from lzzx_nerf_tpu_torch.parallel.steps import head_steps
    from lzzx_nerf_tpu_torch.serving import InferenceSession
    from lzzx_nerf_tpu_torch.serving.streaming import NullSink, RawFileSink

    lines, ok = [], True
    data = os.path.join(root, "oracle")
    base = [data, "--asr_model", "deepspeech", "--iters", str(PAR_STEPS),
            "--eval_interval", "1000", "--train_compact_warmup", "50",
            "--preload", "1", "--budget_frac", "0.75"]
    runs = {}
    for name, more in (("plain", []),
                       ("patch", ["--patch_size", "32",
                                  "--allow_rand_lpips", "1"]),
                       ("dp1", ["--data_parallel", "1"])):
        ws = os.path.join(root, f"par_{name}")
        rc, sec, out = _cli(base + ["--workspace", ws] + more)
        its = re.findall(r"\(([0-9.]+) it/s\)", out)
        runs[name] = (rc, sec, its, ws, out)
        r_ok = rc == 0 and "training done" in out
        if name == "patch":
            r_ok &= "--patch_size > 1 LPIPS weights: RANDOM" in out
        if name == "dp1":
            r_ok &= "[INFO] data-parallel over 1 devices" in out
        ok &= r_ok
        if not r_ok:
            lines += [f"[parallel]   {ln}" for ln in out.splitlines()[-15:]]
    (rc_p, s_p, i_p, _, _), (_, s_l, i_l, _, _), (rc_d, s_d, i_d, _, _) = (
        runs["plain"], runs["patch"], runs["dp1"])
    lines.append(
        f"[patch] the CLI's head, {PAR_STEPS} steps at 512² (grid 128, "
        f"65,536 rays; compacted from 50): --patch_size 32 "
        f"--allow_rand_lpips 1 logged {i_l} it/s ({s_l:.1f} s wall with "
        f"process start), the plain head {i_p} it/s ({s_p:.1f} s) [{smi}] "
        f"{'OK' if runs['patch'][0] == 0 else 'FAIL'}")
    # --data_parallel 1 against the plain run, one step each in this
    # process: after 100 steps two plain runs on the card part as much as
    # either does from the data-parallel one (the tables' atomic
    # scatter-adds sum in a run-dependent order, and Adam's first steps
    # turn near-zero gradients into full-size moves), so the checkpoints
    # are held to the [train] rule after the first step
    from lzzx_nerf_tpu_torch import cli

    one = base[:4] + ["1"] + base[5:]
    for name, more in (("plain1", []), ("dp1_1", ["--data_parallel", "1"])):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(one + ["--workspace", os.path.join(root, f"par_{name}"),
                            *more])
    up_p, st_p = _ckpt_updates(os.path.join(root, "par_plain1"))
    up_d, st_d = _ckpt_updates(os.path.join(root, "par_dp1_1"))
    worst, failed = {}, []
    c_ok = (st_p == st_d == 1 and rc_p == 0 and rc_d == 0
            and _grads_agree(up_d, up_p, worst, failed))
    ok &= c_ok
    lines.append(
        f"[parallel] --data_parallel 1 (NCCL, a group of one): {PAR_STEPS} "
        f"steps logged {i_d} it/s ({s_d:.1f} s wall), the plain run "
        f"{i_p} it/s (both from step 0, with the warm-up); after one step "
        f"its checkpoint's parameter moves against the plain run's, "
        f"largest error / largest move per group "
        f"{ {k: f'{v:.2e}' for k, v in sorted(worst.items())} } "
        f"{'OK' if c_ok else f'FAIL {failed}'} [{smi}]")
    rc, sec, out = _cli(base + ["--workspace", os.path.join(root, "par_dp2"),
                                "--data_parallel", "2"])
    e_ok = (rc != 0 and "--data_parallel 2 but only 1 devices visible"
            in out and "training done" not in out)
    ok &= e_ok
    lines.append(f"[parallel] --data_parallel 2 on one card: rc {rc} "
                 f"({sec:.1f} s), "
                 f"{[ln for ln in out.splitlines() if 'data_parallel' in ln][-1:]}"
                 f" {'OK' if e_ok else 'FAIL'}")

    # one compacted data-parallel step: world size 1 on the card, world
    # size 2 over gloo on the CPU
    t1 = time.perf_counter()
    with _group_of_one(dev):
        card = head_steps(_head_steps_spec("cuda"))[0]
    cpu = launch(head_steps, 2, args=(_head_steps_spec("cpu"),),
                 device="cpu", threads=2)
    same_ranks = cpu[0][0]["digest"] == cpu[1][0]["digest"]
    worst, failed = {}, []
    g_ok = _grads_agree(card["grads"], cpu[0][0]["grads"], worst, failed)
    m_c, m_g = card["metrics"], cpu[0][0]["metrics"]
    loss_err = abs(m_c["loss"] - m_g["loss"]) / abs(m_g["loss"])
    d_ok = (g_ok and same_ranks and loss_err <= TRAIN_LOSS_RTOL
            and m_c["n_active"] == m_g["n_active"])
    ok &= d_ok
    lines.append(
        f"[parallel] one compacted data-parallel step 32 (48², grid 32, "
        f"1,024 rays, budget 1,024): world size 1 on the card against world "
        f"size 2 over gloo on the CPU: loss {m_c['loss']:.7f} vs "
        f"{m_g['loss']:.7f} (rel err {loss_err:.2e}, tol {TRAIN_LOSS_RTOL}),"
        f" n_active {m_c['n_active']} vs {m_g['n_active']} (worst shard "
        f"over {m_g['n_active_over']}), the two CPU ranks bit-equal "
        f"{same_ranks}; largest gradient error / largest gradient per group "
        f"{ {k: f'{v:.2e}' for k, v in sorted(worst.items())} } "
        f"{'OK' if d_ok else f'FAIL {failed}'} "
        f"({time.perf_counter() - t1:.1f} s)")

    # serving: infer_data_parallel 2 on one card, then the frame-parallel
    # program over two replicas on it
    ident, feats, offline = live["ident"], live["feats"], live["offline"]
    cfg = live["cfg"].replace(infer_data_parallel=2)

    def settled(sess):
        for _ in range(4):
            r0 = sess.rebuilds
            sess.set_audio_features(feats)
            sess.run(NullSink())
            if sess.rebuilds == r0 and not sess.rebuild_pending():
                return True
        return False

    t1 = time.perf_counter()
    logs = []
    one = InferenceSession(cfg, device=dev, log=logs.append)
    one.load_model(ident["data"], ident["workspace"])
    s_one = settled(one)
    path = os.path.join(root, "dp_one.raw")
    one.set_audio_features(feats)
    one.run(RawFileSink(path))
    with open(path, "rb") as f:
        one_same = f.read() == offline
    c_ok = (s_one and one_same and one._replicas == []
            and any("serving serially" in m for m in logs))
    ok &= c_ok
    lines.append(f"[parallel] infer_data_parallel 2 on one card: serial "
                 f"(chunk {one.chunk}), plan settled {s_one}, {len(feats)} "
                 f"frames byte-equal to [live]'s {one_same} "
                 f"{'OK' if c_ok else 'FAIL'} "
                 f"({time.perf_counter() - t1:.1f} s)")
    del one

    t1 = time.perf_counter()
    sess = InferenceSession(cfg, device=dev, devices=[dev, dev],
                            log=lambda m: None)
    sess.load_model(ident["data"], ident["workspace"])
    s_dp = settled(sess)
    frame_bytes = sess.H * sess.W * 3
    field_checks, select_checks, eager = [], [], {}
    sess.graph = False
    with kernels_held(field_checks, select_checks):
        sess.set_audio_features(feats[:sess.chunk])
        sess.run(on_frame=lambda i, b: eager.__setitem__(i, b))
    sess.graph = None
    e_same = all(eager[i].tobytes() == offline[i * frame_bytes:
                                               (i + 1) * frame_bytes]
                 for i in range(sess.chunk))
    f_ok = bool(field_checks) and all(e["ok"] for _, e in field_checks)
    s_ok = bool(select_checks) and all(e for _, e, _ in select_checks)
    path = os.path.join(root, "dp_two.raw")
    sess.set_audio_features(feats)
    sess.run(NullSink())         # capture each replica's graph, warm up
    sess.set_audio_features(feats)
    kernels.reset_launches()
    sess.reset_replica_launches()
    n, dt = sess.run(RawFileSink(path))
    torch_sync(dev)
    launches = dict(kernels.launches)
    per_rep = sess.replica_launches
    with open(path, "rb") as f:
        dp_same = f.read() == offline
    p_ok = (s_dp and dp_same and e_same and f_ok and s_ok
            and len(per_rep) == 2 and all(dense_launched(r) for r in per_rep)
            and dense_launched(launches))
    ok &= p_ok
    lines.append(
        f"[parallel] frame-parallel over 2 replicas on {dev} (chunk "
        f"{sess.chunk}, plan settled {s_dp}, K2={sess.k2} budget="
        f"{sess.budget} stage2={sess.stage2_budget}): {n} captured frames "
        f"byte-equal to [live]'s serial program {dp_same}, "
        f"{n / dt:.2f} frames/s against [live]'s run() "
        f"{live['fps']:.2f}; launches per replica {per_rep} (total "
        f"{launches}); eager chunk: field within FIELD_TOL at "
        f"{sum(e['ok'] for _, e in field_checks)} of {len(field_checks)} "
        f"launches (max share of tol colour "
        f"{max((e['color_share'] for _, e in field_checks), default=0):.3f}"
        f"), select equal at {sum(e for _, e, _ in select_checks)} of "
        f"{len(select_checks)}, frames byte-equal {e_same} [{smi}] "
        f"{'OK' if p_ok else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
    del sess
    torch.cuda.empty_cache()
    return ok, lines, launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16,
                    help="frames of the main-path run (whole chunks)")
    ap.add_argument("--fps-frames", type=int, default=32)
    ap.add_argument("--state", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "trained",
        "production_state.pkl"))
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's per-kernel register/spill report")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lzzx_nerf_tpu_torch import bench, kernels
    from lzzx_nerf_tpu_torch.ops import fused_field as ff
    from lzzx_nerf_tpu_torch.ops import march_select as ms
    from lzzx_nerf_tpu_torch.serving import ServingSession

    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} (0.0 s)")

    # ---- build
    t0 = time.perf_counter()
    info = kernels.build(("-Xptxas", "-v") if args.ptxas else ())
    cold = [n for n, i in info.items() if not i["cached"]]
    log(f"[build] {len(info)} libraries, "
        f"{'cold: ' + ', '.join(cold) if cold else 'cached'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if args.ptxas:
        for n, i in info.items():
            for line in i["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[ptxas] {n}: {line.strip()}")
    log(f"[occupancy] fused_field: {kernels.info('fused_field')}")
    hmma = sass_hmma(info["fused_field"]["path"])
    sass_ok = hmma is None or hmma > 0
    log(f"[sass] fused_field: "
        f"{'cuobjdump not found, not checked' if hmma is None else f'{hmma} HMMA instructions'} "
        f"{'OK' if sass_ok else 'FAIL'}")

    # ---- session
    t0 = time.perf_counter()
    sess = ServingSession(args.state, device=dev, chunk=8,
                          log=lambda m: log(f"[session] {m}"))
    torch.cuda.synchronize()
    P = len(sess.poses)
    log(f"[session] 512² K2={sess.k2} bucket={sess.bucket} budget="
        f"{sess.budget} long={sess.long_budget} eval={sess.eval_budget} "
        f"stage2={sess.stage2_budget} torso_pixels="
        f"{int((sess.torso_plan.idx < sess.H * sess.W).sum())} over {P} "
        f"poses ({time.perf_counter() - t0:.1f} s)")
    A = int(sess.meta["audio_dim"])
    stage2_built = sess.stage2_budget

    def stream(n, seed=0):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((n, 8, 16, A)).astype(np.float32),
                [0.15 + 0.1 * np.sin(f / 4) for f in range(n)])

    # ---- every kernel launch of 96 eager frames (32 poses x 3 seeded
    # audio windows) held to its plain version; the first frame's inputs
    # are kept for the timings
    t0 = time.perf_counter()
    n_win = 3
    rng = np.random.default_rng(1)
    windows = rng.standard_normal((n_win, 8, 16, A)).astype(np.float32)
    auds96 = np.repeat(windows, P, axis=0)
    eyes96 = [0.15 + 0.1 * np.sin(f / 4) for f in range(n_win * P)]
    pose96 = [f % P for f in range(n_win * P)]
    captured = {"field": [], "select": []}
    field_checks = []   # (N, field_errors) per field launch, in order
    select_checks = []  # (G, equal, samples) per select launch
    with kernels_held(field_checks, select_checks, captured):
        sess.reset_audio()
        run96 = sess.render(auds96, eyes96, pose_ids=pose96, graph=False)
    torch.cuda.synchronize()
    field_n = [c[1].shape[0] for c in captured["field"]]
    log(f"[capture] {len(run96['frames'])} eager frames ({P} poses x "
        f"{n_win} audio windows): field N={field_n} "
        f"select B={[c[4].shape[0] for c in captured['select']]} "
        f"G={[c[1].shape[1] for c in captured['select']]} "
        f"max n_stage2={max(run96['n_stage2'])}/{sess.stage2_budget} "
        f"({time.perf_counter() - t0:.1f} s)")

    log(f"[session] after the 96 frames: stage2={sess.stage2_budget} "
        f"(the stage-2 escape; built at {stage2_built}), budget="
        f"{sess.budget} eval={sess.eval_budget} K2={sess.k2}")

    ok = sass_ok

    # ---- kernel 1 at every launch: the largest errors per stage shape and
    # their share of FIELD_TOL (the margin is its inverse)
    for n in dict.fromkeys(m for m, _ in field_checks):
        errs = [e for m, e in field_checks if m == n]
        f_ok = all(e["ok"] for e in errs)
        ok &= f_ok
        worst_c = max(e["color_share"] for e in errs)
        worst_s = max(e["sigma_share"] for e in errs)
        log(f"[field] N={n} over {len(errs)} launches: color err max "
            f"{max(e['color'] for e in errs):.3g} (median "
            f"{float(np.median([e['color'] for e in errs])):.3g}) max share "
            f"of tol {worst_c:.3f}; sigma err max "
            f"{max(e['sigma'] for e in errs):.3g} max share of tol "
            f"{worst_s:.3f} {'OK' if f_ok else 'FAIL'}")
    for g in dict.fromkeys(g for g, _, _ in select_checks):
        eq = [e for gg, e, _ in select_checks if gg == g]
        ok &= all(eq)
        log(f"[select] G={g}: equal at {sum(eq)} of {len(eq)} launches, "
            f"{sum(n for gg, _, n in select_checks if gg == g)} samples "
            f"{'OK' if all(eq) else 'FAIL'}")

    # ---- kernel 1: the field (triplane lookup + SH basis + MLP), at the
    # frame's two launch shapes (stage 1 after the re-compaction, stage 2)
    field_rows = []
    for stage, (fw, pts, dirs, tables, spec, bound, wpack) in enumerate(
            captured["field"], 1):
        t0 = time.perf_counter()
        n = pts.shape[0]
        e = field_checks[stage - 1][1]   # this launch, held above
        xy, yz, xz = tables["xy"], tables["yz"], tables["xz"]
        flops = 2.0 * FIELD_MACS * n
        nbytes = (n * (3 + 3 + 4) * 4 + wpack.numel() * 4
                  + sum(t.numel() * t.element_size() for t in (xy, yz, xz)))
        b_bytes = 1e3 * nbytes / PEAK_BYTES
        b_f32 = max(1e3 * flops / PEAK_F32_FLOPS, b_bytes)
        b_tc = max(1e3 * 3 * flops / PEAK_TF32_FLOPS, b_bytes)
        ms_k = cuda_time_ms(lambda: ff.fused_field_cuda(
            pts, dirs, xy, yz, xz, bound, wpack))
        ms_p = cuda_time_ms(lambda: ff.field_reference(
            fw, pts, dirs, tables, spec, bound), reps=5, warmup=1)
        field_rows.append({"n": n, "err": e["err"], "ms": ms_k,
                           "plain_ms": ms_p, "bound_tc": b_tc,
                           "bound_f32": b_f32,
                           "by": "operations" if b_tc > b_bytes
                           else "bytes"})
        log(f"[kernel] fused_field stage {stage} N={n} "
            f"max_abs_err={e['err']:.3g} (color {e['color']:.3g}, sigma "
            f"{e['sigma']:.3g}) ms={ms_k:.4f} plain_ms={ms_p:.4f} "
            f"bound_ms 3xTF32={b_tc:.4f} (share {b_tc / ms_k:.3f}) "
            f"f32-FMA={b_f32:.4f} (share {b_f32 / ms_k:.3f}) "
            f"{'OK' if e['ok'] else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")

    # ---- kernel 2: march select, at both bucket shapes
    sel_rows = []
    for which, a in zip(("short", "long"), captured["select"]):
        t0 = time.perf_counter()
        (table, gx, gy, w0, ro, rd, ts, te, sv, bound, dt, H, K2, S) = a[:14]
        sel_args = (table, gx.to(torch.int32).contiguous(),
                    gy.to(torch.int32).contiguous(),
                    w0.to(torch.int32).contiguous(), ro.contiguous(),
                    rd.contiguous(), ts.contiguous(), te.contiguous(),
                    sv.contiguous(), bound, dt, H, K2, S)
        sel_k = ms.march_select(*sel_args)
        sel_p = ms.march_select_reference(*sel_args)
        torch.cuda.synchronize()
        G = gx.shape[1]
        log(f"[occupancy] march_select at G={G} S={S}: "
            f"{kernels.info('march_select', G, S)}")
        s_ok = bool(torch.equal(sel_k, sel_p))
        ok &= s_ok
        b, by, _, _ = select_bound(sel_p, sel_args)
        s_ms = cuda_time_ms(lambda: ms.march_select_cuda(*sel_args))
        s_plain = cuda_time_ms(lambda: ms.march_select_reference(*sel_args),
                               reps=5, warmup=1)
        sel_rows.append({"err": float((sel_k.long() - sel_p.long()).abs()
                                      .max()) if sel_k.numel() else 0.0,
                         "ms": s_ms, "plain_ms": s_plain, "bound": b,
                         "by": by})
        log(f"[kernel] march_select {which} B={ro.shape[0]} G={G} K2={K2} "
            f"S={S} equal={s_ok} samples={int((sel_k >= 0).sum())} "
            f"ms={s_ms:.4f} plain_ms={s_plain:.4f} bound_ms={b:.4f} "
            f"({by}; share {b / s_ms:.3f}) {'OK' if s_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")

    # ---- the main path: the session's captured chunk program, counters
    # around it
    F = -(-args.frames // sess.chunk) * sess.chunk
    auds, eyes = stream(F)
    sess.reset_audio()
    sess.render(auds[:sess.chunk], eyes[:sess.chunk])   # capture, warm up
    t0 = time.perf_counter()
    sess.reset_audio()
    kernels.reset_launches()
    res = sess.render(auds, eyes)
    launches = dict(kernels.launches)
    frames_ok = (len(res["frames"]) == F and all(
        f.shape == (sess.H * sess.W * 3 // 2,) and f.dtype == np.uint8
        for f in res["frames"]))
    launched = dense_launched(launches)
    counters_ok = (max(res["n_active"]) <= sess.budget
                   and max(res["n_winmax"]) <= sess.k2
                   and max(res["n_real"]) <= sess.eval_budget
                   and max(res["n_long"]) <= sess.long_budget)
    ok &= frames_ok and launched and counters_ok
    log(f"[slice] {F} frames 512² torso, captured: "
        f"{F / res['seconds']:.2f} frames/s ({res['seconds']:.3f} s) "
        f"max n_active={max(res['n_active'])}/{sess.budget} "
        f"n_winmax={max(res['n_winmax'])}/{sess.k2} "
        f"n_real={max(res['n_real'])}/{sess.eval_budget} "
        f"n_long={max(res['n_long'])}/{sess.long_budget} "
        f"n_stage2={max(res['n_stage2'])}/{sess.stage2_budget} "
        f"launches={launches} graph captures={sess.captures} "
        f"{'OK' if frames_ok and launched and counters_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the same frames through the eager chunk program
    t0 = time.perf_counter()
    sess.reset_audio()
    eager = sess.render(auds, eyes, graph=False)
    same = [bool(np.array_equal(a, b))
            for a, b in zip(eager["frames"], res["frames"])]
    same_cnt = all(eager[k] == res[k] for k in ("n_active", "n_winmax",
                                                "n_stage2", "n_real",
                                                "n_short", "n_long"))
    g_ok = all(same) and len(same) == F and same_cnt
    ok &= g_ok
    log(f"[graph] captured vs eager: {sum(same)} of {F} frames byte-equal, "
        f"counters equal {same_cnt} {'OK' if g_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- frame 0 through the plain versions on the card
    t0 = time.perf_counter()
    sess.reset_audio()
    enc = sess.encode_audio(torch.as_tensor(auds[0], device=dev))
    eye0 = torch.tensor([eyes[0]], device=dev)
    kern = sess.render_frame(0, enc, eye0, use_kernels=True)
    plain = sess.render_frame(0, enc, eye0, use_kernels=False)
    torch.cuda.synchronize()
    img_err = float((kern["image"] - plain["image"]).abs().max())
    yuv_err = int((kern["yuv"].int() - plain["yuv"].int()).abs().max())
    same_bytes = bool(np.array_equal(kern["yuv"].cpu().numpy(),
                                     res["frames"][0]))
    f0_ok = (img_err <= FRAME_TOL and yuv_err <= 1 and same_bytes
             and int(kern["n_active"]) == int(plain["n_active"])
             and int(kern["n_real"]) == int(plain["n_real"])
             and bool(torch.isfinite(kern["image"]).all()))
    ok &= f0_ok
    log(f"[frame0] kernels vs plain: max_abs_err={img_err:.3g} "
        f"yuv_max_diff={yuv_err} same_as_slice={same_bytes} "
        f"n_active={int(kern['n_active'])}/{int(plain['n_active'])} "
        f"n_real={int(kern['n_real'])}/{int(plain['n_real'])} "
        f"{'OK' if f0_ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")

    # ---- frames/s, eager and captured, over the trajectory
    t0 = time.perf_counter()
    fa, fe = stream(-(-args.fps_frames // sess.chunk) * sess.chunk, seed=2)
    fps = {}
    for mode in (False, True, False, True):
        sess.reset_audio()
        r = sess.render(fa, fe, graph=mode)
        fps.setdefault("captured" if mode else "eager", []).append(
            len(fa) / r["seconds"])
    log(f"[fps] {len(fa)} frames over the {P} poses, in turns: eager "
        f"{', '.join(f'{v:.2f}' for v in fps['eager'])} frames/s, captured "
        f"{', '.join(f'{v:.2f}' for v in fps['captured'])} frames/s "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- a forced escape: a ray budget below the frames' demand
    t0 = time.perf_counter()
    logs = []
    small = ServingSession(args.state, device=dev, chunk=8,
                           poses=sess.poses[:4], budget=65536,
                           log=logs.append)
    ea, ee = stream(24, seed=3)
    r_small = small.render(ea, ee)
    conv = ServingSession(args.state, device=dev, chunk=8,
                          poses=sess.poses[:4], budget=small.budget,
                          march_bucket=small.bucket or False,
                          stage2_budget=small.stage2_budget,
                          log=lambda m: None)
    r_conv = conv.render(ea, ee)
    warned = any("rebuilding with" in m for m in logs)
    rebuilt = sum("rebuild at a chunk boundary" in m for m in logs)
    after = all(np.array_equal(r_small["frames"][f], r_conv["frames"][f])
                for f in range(16, 24))
    cut = not np.array_equal(r_small["frames"][0], r_conv["frames"][0])
    e_ok = (warned and rebuilt >= 1 and after and cut
            and small.budget > 65536 and len(r_small["frames"]) == 24)
    ok &= e_ok
    log(f"[escape] budget 65536 -> {small.budget} (long "
        f"{small.long_budget}, eval {small.eval_budget}, stage 2 "
        f"{small.stage2_budget}) after "
        f"{rebuilt} rebuild(s), {small.captures} captures; frames 16-23 "
        f"equal to the converged session {after}, frame 0 cut {cut} "
        f"{'OK' if e_ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    for m in logs:
        if "[WARN]" in m:
            log(f"[escape]   {m}")
    del small, conv

    # ---- a short run of the port bench
    t0 = time.perf_counter()
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--frames", "16"])
    lines = buf.getvalue().strip().splitlines()
    try:
        line = json.loads(lines[-1])
        b_ok = (rc == 0 and len(lines) == 1
                and line["metric"] == "render_fps_512" and line["value"] > 0)
    except (ValueError, KeyError, IndexError):
        b_ok = False
    ok &= b_ok
    log(f"[bench] {lines} {'OK' if b_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the head training step (runs neither hand kernel)
    t0 = time.perf_counter()
    p_ok, p_lines = train_parity(dev)
    for line in p_lines:
        log(line)
    t_ok, t_lines, run = train_production(dev)
    for line in t_lines:
        log(line)
    it0 = TRAIN_WARMUP + TRAIN_COMPACT + 5
    for line in train_profile(lambda k: run.train_step(it0 + k, True),
                              "one compacted step"):
        log(line)
    # the staged training composite: card vs CPU, then timed against the
    # single-pass compacted step at the production point; a patch step
    s_ok, s_lines = stage_parity(dev)
    sp_ok, sp_lines = stage_production(run, dev, smi)
    pa_ok, pa_line = patch_parity(dev)
    dp_ok, dp_lines = dp_production(run, dev, smi)
    for line in s_lines + sp_lines + [pa_line] + dp_lines:
        log(line)
    p_ok &= s_ok and sp_ok and pa_ok and dp_ok
    ok &= p_ok and t_ok
    log(f"[train] {'OK' if p_ok and t_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- a bf16 head step (the CLI's field under --fp16), card vs CPU
    t0 = time.perf_counter()
    h_ok, line = fp16_parity(dev)
    log(line)
    ok &= h_ok
    log(f"[fp16] {'OK' if h_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the lips finetune (runs neither hand kernel), over the head run
    t0 = time.perf_counter()
    l_ok, line = lips_parity(dev)
    log(line)
    lp_ok, lines, lips = lips_production(run, dev)
    for line in lines:
        log(line)
    for line in train_profile(lambda k: lips.step(LIPS_STEPS + k),
                              "one lips step"):
        log(line)
    lips.finish()
    del lips
    ok &= l_ok and lp_ok
    log(f"[lips] {'OK' if l_ok and lp_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the torso stage (runs neither hand kernel), over the head run
    t0 = time.perf_counter()
    tp_ok, lines = torso_parity(dev)
    for line in lines:
        log(line)
    tt_ok, lines, torso = torso_production(run, dev)
    for line in lines:
        log(line)
    for line in train_profile(
            lambda k: torso.train_step(TORSO_STEPS + 10 + k),
            "one torso step"):
        log(line)
    ok &= tp_ok and tt_ok
    del run, torso
    log(f"[torso] {'OK' if tp_ok and tt_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the whole recipe at a reduced depth, served on the card
    t0 = time.perf_counter()
    r_ok, lines = recipe_phase(dev)
    for line in lines:
        log(line)
    ok &= r_ok
    log(f"[recipe] {'OK' if r_ok else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the serving stack a user runs: dataset identity, run / run_live
    # into a sink, and the HTTP API
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        v_ok, lines, live = live_phase(dev, root, smi)
        for line in lines:
            log(line)
        ok &= v_ok
        log(f"[live] {'OK' if v_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        w_ok, lines = webapi_phase(dev, root, live, smi)
        for line in lines:
            log(line)
        ok &= w_ok
        log(f"[webapi] {'OK' if w_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        # the reference-checkpoint path: a hash identity over [live]'s
        # dataset through the field kernel's enc_x entry
        t0 = time.perf_counter()
        r_ok, lines, enc_row = reference_phase(dev, root, smi, live,
                                               args.state)
        for line in lines:
            log(line)
        ok &= r_ok
        log(f"[reference] {'OK' if r_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        f_ok, lines = fallback_phase(dev, root, smi)
        for line in lines:
            log(line)
        ok &= f_ok
        log(f"[fallback] {'OK' if f_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        # the Config alternates of the JAX session, each beside nb5w
        t0 = time.perf_counter()
        a_ok, lines, alt_launches = alternates_phase(dev, root, smi)
        for line in lines:
            log(line)
        ok &= a_ok
        log(f"[alternates] {'OK' if a_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        for name, fn in (("cli", cli_phase), ("mesh", mesh_phase)):
            t0 = time.perf_counter()
            p_ok, lines = fn(dev, root, smi)
            for line in lines:
                log(line)
            ok &= p_ok
            log(f"[{name}] {'OK' if p_ok else 'FAIL'} "
                f"({time.perf_counter() - t0:.1f} s)")
        # patch LPIPS and --data_parallel on [cli]'s dataset; the
        # frame-parallel session over [live]'s identity, whose captured
        # run's counts join the main path's
        t0 = time.perf_counter()
        d_ok, lines, par_launches = parallel_phase(dev, root, smi, live)
        for line in lines:
            log(line)
        ok &= d_ok
        log(f"[parallel] {'OK' if d_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        # --asr on [cli]'s workspace: the counts of its default run join
        # the main path's
        t0 = time.perf_counter()
        a_ok, lines, asr_launches = asr_phase(dev, root, smi)
        for line in lines:
            log(line)
        ok &= a_ok
        log(f"[asr] {'OK' if a_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        p_ok, lines = preprocess_phase(dev, root, smi)
        for line in lines:
            log(line)
        ok &= p_ok
        log(f"[preprocess] {'OK' if p_ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")

    # launches: the main path's ([slice]), --asr's default run and the
    # frame-parallel captured run ([parallel]), the enc_x entry's from
    # [reference]'s captured run; times per frame: both
    # field launches (stage 1, stage 2) and both select launches (short,
    # long bucket) of the first frame, summed
    def total(rows, key):
        return sum(r[key] for r in rows)

    report = {"kernels": [
        {"name": "fused_field", "route": "cuda",
         "source": "lzzx_nerf_tpu_torch/csrc/fused_field.cu",
         "replaces": "lzzx_nerf_tpu/ops/fused_field.py:167",
         "launches": (launches["fused_field"]
                      + asr_launches["fused_field"]
                      + par_launches["fused_field"]
                      + alt_launches["fused_field"]),
         "max_abs_err": max(e["err"] for _, e in field_checks),
         "ms": total(field_rows, "ms"),
         "plain_ms": total(field_rows, "plain_ms"),
         "bound_ms": total(field_rows, "bound_tc"),
         "bound_by": field_rows[0]["by"], "library_ms": None},
        # the enc_x entry's launches: [reference]'s captured run and
        # [alternates]' float32-table path
        dict(enc_row, launches=enc_row["launches"]
             + alt_launches["fused_field_enc"]),
        {"name": "march_select", "route": "cuda",
         "source": "lzzx_nerf_tpu_torch/csrc/march_select.cu",
         "replaces": "lzzx_nerf_tpu/ops/march_select_pallas.py:56",
         "launches": (launches["march_select"]
                      + asr_launches["march_select"]
                      + par_launches["march_select"]
                      + alt_launches["march_select"]),
         "max_abs_err": max(r["err"] for r in sel_rows),
         "ms": total(sel_rows, "ms"), "plain_ms": total(sel_rows, "plain_ms"),
         "bound_ms": total(sel_rows, "bound"),
         "bound_by": max(sel_rows, key=lambda r: r["bound"])["by"],
         "library_ms": None},
    ]}
    log(json.dumps(report))
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    log(f"{smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
