"""Frames per second of the port's serving frame (the port's counterpart of
bench.py's trained-state path).

    python3 -m lzzx_nerf_tpu_torch.bench [--frames 64] [--chunk 8]
                                         [--res 512] [--no-graph]

Builds a ServingSession over the trained state at the first training
pose (bench.py's camera), renders the first chunk as a warm-up (which
captures the chunk's CUDA graph), then times --frames frames (rounded up
to whole chunks; a second warm-up chunk when the first asks for a
rebuild) of seeded audio and eye
values (bench.py's streams: numpy seed 0, one [chunk, 8, 16, audio_dim]
draw per chunk, eyes 0.15 + 0.1 sin(f / 4)) until the last yuv420p frame
is on the host. Prints one JSON line, bench.py's:
{"metric": "render_fps_<res>", "value", "unit": "fps", "vs_baseline"};
everything else goes to stderr.

Diverges from bench.py: --bound other than 1 with a trained state raises
(bench.py drops the state without a word and measures another scene).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_STATE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "trained", "production_state.pkl")


def bench_streams(frames: int, chunk: int, audio_dim: int):
    """bench.py's seeded inputs: audio windows [n_chunks * chunk, 8, 16,
    audio_dim] and eye values, one draw per chunk."""
    rng = np.random.default_rng(0)
    n_chunks = -(-frames // chunk)
    auds = np.concatenate([rng.standard_normal((chunk, 8, 16, audio_dim))
                           for _ in range(n_chunks)]).astype(np.float32)
    eyes = 0.15 + 0.1 * np.sin(np.arange(n_chunks * chunk) / 4)
    return auds, eyes.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--state", default=_STATE)
    ap.add_argument("--bound", type=float, default=1.0,
                    help="scene bound; the trained state is a bound-1 "
                    "(cascade-1) scene, so any other value raises")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain versions")
    ap.add_argument("--graph", action=argparse.BooleanOptionalAction,
                    default=None, help="capture each chunk as a CUDA graph "
                    "(default on a GPU)")
    ap.add_argument("--bucket", action=argparse.BooleanOptionalAction,
                    default=True, help="the short/long bucket march")
    ap.add_argument("--recompact", action=argparse.BooleanOptionalAction,
                    default=True, help="the post-march eval re-compaction")
    args = ap.parse_args(argv)
    if args.bound != 1.0:
        raise SystemExit(
            f"--bound {args.bound}: the trained state is a bound-1 "
            "(cascade-1) scene, and the port has no other scene to measure")

    import torch

    from . import kernels
    from .serving import ServingSession
    from .serving.state_io import load_trained_state

    def log(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    poses = np.asarray(load_trained_state(args.state)["meta"]["poses"],
                       np.float32)[:1]
    sess = ServingSession(args.state, device=args.device, poses=poses,
                          res=args.res, chunk=args.chunk, log=log,
                          march_bucket=args.bucket,
                          eval_recompact=args.recompact)
    C = sess.chunk
    auds, eyes = bench_streams(args.frames, C, int(sess.meta["audio_dim"]))
    sess.render(auds[:C], eyes[:C], graph=args.graph)   # warm-up, capture
    if sess.rebuild_pending():
        # an escape fired in the warm-up: rebuild and capture before timing
        sess.render(auds[:C], eyes[:C], graph=args.graph)
    sess.reset_audio()
    kernels.reset_launches()
    n = len(auds)
    out = sess.render(auds, eyes, graph=args.graph)
    fps = n / out["seconds"]
    print(json.dumps({"metric": f"render_fps_{args.res}",
                      "value": round(fps, 3), "unit": "fps",
                      "vs_baseline": round(fps / 25.0, 3)}), flush=True)
    dev = sess.device
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    log(f"{card}: {1e3 * out['seconds'] / n:.3f} ms/frame over {n} frames, "
        f"res={args.res}, chunk={C}, captures={sess.captures}, "
        f"n_active={max(out['n_active'])}/{sess.budget}, "
        f"n_real={max(out['n_real'])}/{sess.eval_budget}, "
        f"n_long={max(out['n_long'])}/{sess.long_budget}, "
        f"n_stage2={max(out['n_stage2'])}/{sess.stage2_budget}, "
        f"kernel launches per frame "
        f"{ {k: v / n for k, v in kernels.launches.items()} }")
    return 0


if __name__ == "__main__":
    sys.exit(main())
