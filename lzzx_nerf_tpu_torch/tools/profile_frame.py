"""Where the time of the 512² serving frame goes, on one GPU, eager and
captured.

    python3 -m lzzx_nerf_tpu_torch.tools.profile_frame [--frames 16]
    python3 -m lzzx_nerf_tpu_torch.tools.profile_frame --data DIR \
        --workspace WS [--frames 16]

Builds the serving session from trained/production_state.pkl (the
configuration chip_smoke.py drives: the plan over the state's 32 poses,
bucket march and eval re-compaction on), or, with --data and --workspace,
an InferenceSession over that identity (the Config's plan, settled on the
traced features first; a hash head's identity among them), and for each
way of running the chunk program — eager, then captured as a CUDA graph —
renders a warm-up chunk, then traces --frames frames (pose 0 of the
state, or run()'s poses of the identity; whole chunks) with
torch.profiler and prints: wall ms per frame (host clock around
synchronised work), device ms per frame (the sum of kernel times), the
device's idle share (1 - device / wall), kernels executed per frame, the
host's launch calls per frame (kernel launches, graph launches and
copies the host issues), the kernels by total device time (also written
to --out when given), and for a hash head the share of the frame's
device time spent in grid_encode (eager only: a replayed graph has no
host ranges) and in the field kernel's enc_x entry.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def _profile(sess, auds, eyes, graph: bool):
    from torch.profiler import ProfilerActivity, profile

    C = sess.chunk
    sess.render(auds[:C], eyes[:C], pose_ids=[0] * C, graph=graph)
    sess.reset_audio()
    torch.cuda.synchronize()
    F = len(auds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.render(auds, eyes, pose_ids=[0] * F, graph=graph)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / F
    events = prof.key_averages()
    # kernel events only: a CPU op's self device time repeats its kernels'
    rows = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    host_calls = sum(e.count for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.key.startswith(("cudaLaunch", "cuLaunch",
                                           "cudaGraphLaunch",
                                           "cudaMemcpy")))
    return wall, rows, host_calls


def _profile_run(sess, feats, graph: bool):
    """_profile for an InferenceSession: run() over feats (whole chunks),
    after a warm-up chunk, with the head's encode_x inside a
    record_function("grid_encode") range. Returns (wall, rows,
    host_calls, grid_encode device us)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..serving.streaming import NullSink

    field = sess.field
    encode_x = field.encode_x

    def labelled(*a, **k):
        with record_function("grid_encode"):
            return encode_x(*a, **k)

    sess.graph = None if graph else False
    C = sess.chunk
    try:
        field.encode_x = labelled
        sess.set_audio_features(feats[:C])
        sess.run(NullSink())
        sess.set_audio_features(feats)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n, _ = sess.run(NullSink())
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
    finally:
        del field.encode_x
        sess.graph = None
    events = prof.key_averages()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    # kernels only: the range's own device-side annotation (its span on
    # the device, gaps included) is not a kernel
    rows = [e for e in events
            if e.device_type == cuda and e.key != "grid_encode"]
    host_calls = sum(e.count for e in events
                     if e.device_type == cpu
                     and e.key.startswith(("cudaLaunch", "cuLaunch",
                                           "cudaGraphLaunch",
                                           "cudaMemcpy")))
    # the device time of the kernels launched inside the host range
    enc_us = sum(e.device_time_total for e in events
                 if e.key == "grid_encode" and e.device_type == cpu)
    return wall, rows, host_calls, enc_us


def report(title: str, F: int, wall: float, rows, host_calls: int,
           enc_us: float = 0.0) -> tuple:
    """The lines of one traced run -> (lines, {"wall_ms", "device_ms",
    "idle", "kernels", "host_calls", "grid_encode_share",
    "field_enc_share"}) per frame; None when no device time was
    recorded."""
    dev_us = sum(e.self_device_time_total for e in rows)
    if not dev_us:
        return None
    kernels = sum(e.count for e in rows)
    rows = sorted(rows, key=lambda e: -e.self_device_time_total)
    field_enc = sum(e.self_device_time_total for e in rows
                    if "field_enc_kernel" in e.key)
    stats = {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3 / F,
             "idle": 1 - dev_us / 1e3 / F / (wall * 1e3),
             "kernels": kernels / F, "host_calls": host_calls / F,
             "grid_encode_share": enc_us / dev_us,
             "field_enc_share": field_enc / dev_us}
    lines = [
        f"== {title}",
        f"wall ms/frame {stats['wall_ms']:.3f}  device ms/frame "
        f"{stats['device_ms']:.3f}  idle share {stats['idle']:.3f}  "
        f"kernels/frame {stats['kernels']:.1f}  host launch calls/frame "
        f"{stats['host_calls']:.2f}"]
    if enc_us or field_enc:
        lines.append(f"share of device time: grid_encode "
                     f"{stats['grid_encode_share']:.3f}  enc_x entry "
                     f"{stats['field_enc_share']:.3f}")
    lines.append(f"{'kernel':<70} {'ms/frame':>9} {'share':>6} "
                 f"{'calls/fr':>8}")
    for e in rows[:25]:
        ms = e.self_device_time_total / 1e3 / F
        lines.append(f"{e.key[:70]:<70} {ms:9.4f} "
                     f"{e.self_device_time_total / max(dev_us, 1):6.3f} "
                     f"{e.count / F:8.1f}")
    return lines, stats


def profile_identity(sess, feats) -> tuple:
    """An InferenceSession's run() over feats, eager then captured ->
    (lines, {"eager": stats, "captured": stats}); stats as report's, or
    None when the profiler recorded no device time."""
    F = -(-len(feats) // sess.chunk) * sess.chunk
    feats = np.resize(feats, (F, *feats.shape[1:]))
    lines = [f"{torch.cuda.get_device_name(0)}; {F} frames at "
             f"{sess.H}x{sess.W}, encoder {sess.field.encoder}, chunk "
             f"{sess.chunk}; plan K2={sess.k2} bucket={sess.bucket} "
             f"budget={sess.budget} eval={sess.eval_budget}"]
    out = {}
    for graph in (False, True):
        title = "captured (CUDA graph)" if graph else "eager"
        got = report(title, F, *_profile_run(sess, feats, graph))
        out["captured" if graph else "eager"] = got and got[1]
        lines += got[0] if got else [f"== {title}: no device time recorded"]
    return lines, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--state", default=os.path.join("trained",
                                                    "production_state.pkl"))
    ap.add_argument("--data", help="an identity's dataset directory")
    ap.add_argument("--workspace", help="the identity's workspace")
    ap.add_argument("--asr_model", default="deepspeech")
    ap.add_argument("--out", help="also write the tables to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 2

    rng = np.random.default_rng(0)
    if args.data:
        lines = _identity_lines(args, rng)
    else:
        lines = _state_lines(args, rng)
    if lines is None:
        print("profile_frame: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    text = "\n".join(lines)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


def _identity_lines(args, rng):
    """profile_identity over --data / --workspace, the plan settled on
    the traced features first; None without device time."""
    from ..config import Config
    from ..serving import InferenceSession

    sess = InferenceSession(Config(asr_model=args.asr_model),
                            device="cuda", log=lambda m: None)
    sess.load_model(args.data, args.workspace)
    A = int(sess.ds.aud_features.shape[-1])
    feats = rng.standard_normal((args.frames, 16, A)).astype(np.float32)
    for _ in range(4):           # the escapes settle the plan
        sess.set_audio_features(feats)
        sess.run()
        if not sess.rebuild_pending():
            break
    lines, stats = profile_identity(sess, feats)
    return lines if all(stats.values()) else None


def _state_lines(args, rng):
    """The serving session of --state, pose 0; None without device
    time."""
    from ..serving import ServingSession

    sess = ServingSession(args.state, device="cuda", log=lambda m: None)
    C = sess.chunk
    F = -(-args.frames // C) * C
    auds = rng.standard_normal((F, 8, 16, int(sess.meta["audio_dim"]))
                               ).astype(np.float32)
    eyes = [0.25] * F
    lines = [f"{torch.cuda.get_device_name(0)}; {F} frames at 512², pose 0, "
             f"chunk {C}; plan K2={sess.k2} bucket={sess.bucket} "
             f"budget={sess.budget} eval={sess.eval_budget}"]
    for graph in (False, True):
        got = report("captured (CUDA graph)" if graph else "eager", F,
                     *_profile(sess, auds, eyes, graph))
        if got is None:
            return None
        lines += got[0]
    return lines

if __name__ == "__main__":
    sys.exit(main())
