"""Fresh jax.profiler stage budget of the production 1080p frame.

Runs bench.py's exact production frame chain (render_frame + settled
RefineBudgetController) under ``jax.profiler.start_trace(...,
create_perfetto_trace=True)``, then parses the perfetto JSON to report
**device time per XLA program per frame** — the measurement VERDICT r3
item 1 asks for (the last profile dates from the 11.04 build).

Usage:
    python scripts/profile_frame.py [--cpu] [--frames N] [--outdir DIR]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import time

import numpy as np


def parse_perfetto(path: str, n_frames: int) -> None:
    """Sum device-track slice durations per XLA program name."""
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    # Perfetto JSON: thread/process metadata names the tracks; device
    # tracks contain the per-program slices.
    pids = {}
    tids = {}
    for ev in events:
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                pids[ev["pid"]] = ev["args"].get("name", "")
            elif ev.get("name") == "thread_name":
                tids[(ev["pid"], ev.get("tid"))] = ev["args"].get("name", "")
    # The device exposes two tracks: "XLA Modules" (one slice per
    # program execution) and "XLA Ops" (the ops inside).  The program
    # budget comes from the Modules track only; the Ops track gives the
    # within-program breakdown.
    mods = collections.defaultdict(list)
    ops = collections.Counter()
    ops_n = collections.Counter()
    per_prog = collections.Counter()
    per_prog_n = collections.Counter()
    device_total = 0.0
    mod_spans = []  # (ts, ts+dur, name) for op->program attribution
    op_events = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        pname = pids.get(ev["pid"], "")
        tname = tids.get((ev["pid"], ev.get("tid")), "")
        if "/device:" not in pname:
            continue
        name = ev.get("name", "?")
        dur = float(ev.get("dur", 0.0))  # us
        ts = float(ev.get("ts", 0.0))
        if tname == "XLA Modules":
            per_prog[name] += dur
            per_prog_n[name] += 1
            device_total += dur
            mods[name].append(dur)
            mod_spans.append((ts, ts + dur, name))
        elif tname == "XLA Ops":
            ops[name] += dur
            ops_n[name] += 1
            op_events.append((ts, dur, name))
    # Attribute each op slice to the module slice containing its start time.
    mod_spans.sort()
    starts = [s[0] for s in mod_spans]
    import bisect

    prog_ops = collections.defaultdict(collections.Counter)
    prog_ops_n = collections.defaultdict(collections.Counter)
    for ts, dur, name in op_events:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < mod_spans[i][1]:
            prog = mod_spans[i][2]
            prog_ops[prog][name] += dur
            prog_ops_n[prog][name] += 1
    if not per_prog:
        print("NO device slices found; track names were:")
        for k, v in sorted(set(pids.items())):
            print("  pid", k, v)
        for k, v in sorted(set(tids.items())):
            print("  tid", k, v)
        return
    print(f"\ndevice time per program ({n_frames} frames, ms/frame):")
    for name, dur in per_prog.most_common(40):
        print(f"  {dur / n_frames / 1e3:8.2f} ms  x{per_prog_n[name] / n_frames:5.1f}  {name[:90]}")
    print(f"  {'-' * 60}")
    print(f"  {device_total / n_frames / 1e3:8.2f} ms TOTAL device")
    if ops:
        print(f"\ntop ops ({n_frames} frames, ms/frame):")
        for name, dur in ops.most_common(40):
            print(f"  {dur / n_frames / 1e3:8.2f} ms  x{ops_n[name] / n_frames:6.1f}  {name[:90]}")
    # Within-program breakdown for the top programs — this is what names
    # the reducible glue inside e.g. the fused finish+shade program.
    for prog, _ in per_prog.most_common(5):
        sub = prog_ops.get(prog)
        if not sub:
            continue
        tot = sum(sub.values())
        print(f"\n  ops inside {prog[:70]} ({tot / n_frames / 1e3:.2f} ms):")
        for name, dur in sub.most_common(14):
            print(f"    {dur / n_frames / 1e3:8.2f} ms  "
                  f"x{prog_ops_n[prog][name] / n_frames:6.1f}  {name[:80]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--outdir", default="/tmp/grt_profile")
    ap.add_argument("--parse-only", default=None,
                    help="skip the run; parse this perfetto json.gz")
    args = ap.parse_args()

    if args.parse_only:
        parse_perfetto(args.parse_only, args.frames)
        return 0

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from geodesic_raytracing.bench_config import flagship_config
    from geodesic_raytracing.render import background as bg
    from geodesic_raytracing.render.pipeline import (
        RefineBudgetController, render_frame)

    W, H = (1920, 1080) if not args.cpu else (192, 108)
    metric, params, camera, settings, features = flagship_config(W, H)
    if args.cpu:
        import dataclasses

        from geodesic_raytracing.ops.integrate import TraceOptions
        settings = dataclasses.replace(
            settings, trace=TraceOptions(max_steps=4096, method="while"))
    backgrounds = bg.checker_background()
    controller = RefineBudgetController()

    def frame():
        img = render_frame(metric, camera, params, backgrounds, settings,
                           features, controller=controller)
        return jnp.sum(img[::256, ::256])

    # Compile + settle the budget controller (its bucket change recompiles).
    print("settling...", flush=True)
    for i in range(6):
        t0 = time.perf_counter()
        float(frame())
        print(f"  settle frame {i}: {time.perf_counter() - t0:.3f}s",
              flush=True)

    os.makedirs(args.outdir, exist_ok=True)
    jax.profiler.start_trace(args.outdir, create_perfetto_trace=True)
    t0 = time.perf_counter()
    sums = [frame() for _ in range(args.frames)]
    for s in sums:
        float(s)
    dt = (time.perf_counter() - t0) / args.frames
    jax.profiler.stop_trace()
    print(f"profiled {args.frames} frames, {dt * 1e3:.1f} ms/frame "
          f"({W * H / dt / 1e6:.2f} Mrays/s pipelined)", flush=True)

    hits = sorted(glob.glob(os.path.join(
        args.outdir, "**", "*.json.gz"), recursive=True))
    if not hits:
        print("no perfetto trace written; files under outdir:")
        for p in glob.glob(os.path.join(args.outdir, "**", "*"),
                           recursive=True):
            print(" ", p)
        return 1
    print("parsing", hits[-1])
    parse_perfetto(hits[-1], args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
