#!/usr/bin/env python
"""The port's golden videos against the JAX package's committed renders.

Runs the port's golden CLI (lbm_tpu_torch.run_plasma: 200x200, 200 steps,
FFT + periodic, f32 with neutral-delta storage, the configuration of
artifacts/golden_200) with the native AVI writer, or takes the AVIs of an
earlier run (--ours DIR), reads them with lbm_tpu_torch.io.avi.read_frames,
and compares them frame by frame and tile by tile with
artifacts/golden_200/video/*.mp4, both at fps 1 with the reference's fixed
ranges. Both sides are cut with scripts/compare_golden_videos.py's
_tiles_ours, which finds the label strip's height from the frame (14 px in
the committed mp4s, 30 px in the port's AVIs); that script's compare()
reads its --ref side in the C++ layout and would cut the wrong tiles here.
The metrics (per-tile PSNR, the fraction of pixels within CLOSE_TOL) and
the gates (GATES, gates()) are that script's, imported unchanged. Reading
the mp4s needs cv2.

    python scripts/compare_golden_videos_torch.py --device cpu \
        --json artifacts/golden_200/video_compare_torch.json
    python scripts/compare_golden_videos_torch.py --ours DIR   # AVIs of a run

Exit code 0 iff every gate of the profile passes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from compare_golden_videos import (CLOSE_TOL, GATES, VIDEOS,  # noqa: E402
                                   _frames, _tiles_ours, gates)

from lbm_tpu_torch.io import avi  # noqa: E402


def run_golden(out_dir: str, device: str) -> dict:
    """The port's golden CLI run, its videos through the native writer."""
    from lbm_tpu_torch import run_plasma

    os.environ["LBM_VIDEO_FORMAT"] = "avi"
    return run_plasma.main(["--device", device, "--no-plots",
                            "--out", out_dir])


def compare(ours_dir: str, ref_dir: str) -> dict:
    """compare_golden_videos.compare's metric tree, both sides cut by
    _tiles_ours, the port's frames read as BGR like cv2's."""
    results = {}
    for kind, (nrows, labels) in VIDEOS.items():
        ours = avi.read_frames(os.path.join(ours_dir, f"video_{kind}.avi"))
        psnr = {lb: [] for lb in labels}
        close = {lb: [] for lb in labels}
        n = 0
        for fa, fb in zip(ours[..., ::-1],
                          _frames(os.path.join(ref_dir,
                                               f"video_{kind}.mp4"))):
            for lb, a, b in zip(labels, _tiles_ours(fa, nrows),
                                _tiles_ours(fb, nrows)):
                a = a.astype(np.float64)
                b = b.astype(np.float64)
                mse = ((a - b) ** 2).mean()
                psnr[lb].append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
                close[lb].append(
                    float((np.abs(a - b).max(axis=-1) <= CLOSE_TOL).mean()))
            n += 1
        results[kind] = {
            "frames": n,
            "frame_shape": list(ours.shape[1:3]),
            "tiles": {
                lb: {
                    "psnr_mean": round(float(np.mean(psnr[lb])), 2),
                    "psnr_min": round(float(np.min(psnr[lb])), 2),
                    "close_frac_mean": round(float(np.mean(close[lb])), 4),
                }
                for lb in labels
            },
        }
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--ours", default=None,
                    help="directory of the port's video_*.avi (default: "
                         "run the golden CLI into a temporary directory)")
    ap.add_argument("--ref",
                    default=os.path.join(REPO, "artifacts/golden_200/video"))
    ap.add_argument("--device", default="cuda",
                    help="the golden CLI's --device when it runs here")
    ap.add_argument("--json", default=None,
                    help="write the metric tree to this path")
    ap.add_argument("--gates", choices=sorted(GATES), default="f32")
    ap.add_argument("--source", default=None,
                    help="what made --ours, recorded in the JSON")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        if args.ours is None:
            summary = run_golden(tmp, args.device)
            ours = os.path.join(tmp, "video")
            source = (f"lbm_tpu_torch.run_plasma golden, {summary['dtype']}"
                      f" (neutral delta, the f32 default), storage "
                      f"{summary['storage']}, backend {summary['backend']}, "
                      f"on {summary['device']}")
        else:
            ours = args.ours
            source = args.source or ours
        results = compare(ours, args.ref)
    fails = gates(results, args.gates)
    out = {"results": results, "gates_failed": fails,
           "gate_profile": args.gates, "ours": source,
           "ref": os.path.relpath(os.path.abspath(args.ref), REPO)}
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=2)
            fh.write("\n")
    if fails:
        print(f"FAIL: {len(fails)} gate(s) failed", file=sys.stderr)
        return 1
    print("OK: all golden-video gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
