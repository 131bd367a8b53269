"""Scale-knee sweep for the coupled grasp-lift world (round-4 verdict #6).

Sweeps env count x pad resolution on the accelerator and writes one JSON
line per config (same row schema as benchmark_grasp_lift.py). Each config
runs in-process sequentially, so the sweep owns the device.

Usage:
    python scripts/benchmarking/sweep_grasp_lift_scale.py \
        --out logs/grasp_lift_scale_r05.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[2]))  # repo root

from scripts.benchmarking.benchmark_grasp_lift import run  # noqa: E402

# (envs, pad_resolution, steps) — coarse tier up the env axis to find the
# knee; mid tier (4x8x8 = 405 verts/pad vs 75) at RL-relevant batches.
CONFIGS = [
    (128, (2, 4, 4), 20),
    (256, (2, 4, 4), 20),
    (512, (2, 4, 4), 12),
    (1024, (2, 4, 4), 8),
    (64, (4, 8, 8), 12),
    (128, (4, 8, 8), 8),
    (256, (4, 8, 8), 6),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = []
    for n_envs, pad, steps in CONFIGS:
        try:
            row = run(
                "TacEx-Grasp-Lift-Uipc-v0", n_envs, steps,
                {"pad_resolution": pad},
            )
        except Exception as e:  # OOM etc. — record, keep sweeping
            row = {
                "metric": "grasp_lift_env_step[TacEx-Grasp-Lift-Uipc-v0]",
                "num_envs": n_envs, "overrides": {"pad_resolution": pad},
                "error": f"{type(e).__name__}: {e}"[:300],
            }
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
