"""Where the time of the 512² serving frame goes, on one GPU, eager and
captured.

    python3 -m lzzx_nerf_tpu_torch.tools.profile_frame [--frames 16]

Builds the serving session from trained/production_state.pkl (the
configuration chip_smoke.py drives: the plan over the state's 32 poses,
bucket march and eval re-compaction on), and for each way of running the
chunk program — eager, then captured as a CUDA graph — renders a warm-up
chunk, then traces --frames frames of pose 0 (whole chunks) with
torch.profiler and prints: wall ms per frame (host clock around
synchronised work), device ms per frame (the sum of kernel times), the
device's idle share (1 - device / wall), kernels executed per frame, the
host's launch calls per frame (kernel launches, graph launches and
copies the host issues), and the kernels by total device time (also
written to --out when given).
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--state", default=os.path.join("trained",
                                                    "production_state.pkl"))
    ap.add_argument("--out", help="also write the tables to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 2

    from ..serving import ServingSession

    sess = ServingSession(args.state, device="cuda", log=lambda m: None)
    C = sess.chunk
    F = -(-args.frames // C) * C
    rng = np.random.default_rng(0)
    auds = rng.standard_normal((F, 8, 16, int(sess.meta["audio_dim"]))
                               ).astype(np.float32)
    eyes = [0.25] * F
    lines = [f"{torch.cuda.get_device_name(0)}; {F} frames at 512², pose 0, "
             f"chunk {C}; plan K2={sess.k2} bucket={sess.bucket} "
             f"budget={sess.budget} eval={sess.eval_budget}"]
    for graph in (False, True):
        wall, rows, host_calls = _profile(sess, auds, eyes, graph)
        dev_us = sum(e.self_device_time_total for e in rows)
        if not dev_us:
            print("profile_frame: the profiler recorded no device time",
                  file=sys.stderr)
            return 1
        kernels = sum(e.count for e in rows)
        rows.sort(key=lambda e: -e.self_device_time_total)
        lines += [
            f"== {'captured (CUDA graph)' if graph else 'eager'}",
            f"wall ms/frame {wall * 1e3:.3f}  device ms/frame "
            f"{dev_us / 1e3 / F:.3f}  idle share "
            f"{1 - dev_us / 1e3 / F / (wall * 1e3):.3f}  kernels/frame "
            f"{kernels / F:.1f}  host launch calls/frame {host_calls / F:.2f}",
            f"{'kernel':<70} {'ms/frame':>9} {'share':>6} {'calls/fr':>8}"]
        for e in rows[:25]:
            ms = e.self_device_time_total / 1e3 / F
            lines.append(f"{e.key[:70]:<70} {ms:9.4f} "
                         f"{e.self_device_time_total / max(dev_us, 1):6.3f} "
                         f"{e.count / F:8.1f}")
    text = "\n".join(lines)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
