"""Subprocess-per-file test runner with per-file timeouts and a summary table.

Counterpart of the reference's tools/run_all_tests.py + tools/test_settings.py
(per-file timeouts, PrettyTable report). Each test file runs in its own
interpreter (isolating jax/XLA state) on the CPU backend.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DEFAULT_TIMEOUT = 600
PER_FILE_TIMEOUTS = {
    # 17 registered ids x {1,32}-env cells, one jit compile each: the sweep
    # runs ~11 min alone on the CPU test platform and over 900 s when other
    # jobs contend for the host (observed in the round-5 rehearsal run)
    "test_environments.py": 1800,
    "test_taxim_optical.py": 600,
    "test_grasp_lift.py": 1200,  # coupled FEM+ABD Newton solves, 5 compiles
    "test_unified_shell.py": 900,
    "test_factory_uipc.py": 1200,  # scripted insertion at real solver iters
    # 12 example scenes, one subprocess + jit compile each; needs headroom
    # when the host is shared (observed >600 s in the round-5 rehearsal)
    "test_examples.py": 1200,
}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pattern", default="test_*.py")
    p.add_argument(
        "--report",
        default=None,
        help="write a timestamped JSON report (file -> counts/wall time) — "
        "the committed per-round audit artifact (counterpart of the "
        "reference's committed tests/test-reports-*.xml)",
    )
    args = p.parse_args()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    files = sorted((REPO / "tests").glob(args.pattern))
    rows = []
    any_failed = False
    for f in files:
        timeout = PER_FILE_TIMEOUTS.get(f.name, DEFAULT_TIMEOUT)
        t0 = time.time()
        try:
            r = subprocess.run(
                [sys.executable, "-m", "pytest", str(f), "-q", "--no-header"],
                cwd=REPO,
                env=env,
                timeout=timeout,
                capture_output=True,
                text=True,
            )
            ok = r.returncode == 0
            tail = (r.stdout.strip().splitlines() or [""])[-1]
        except subprocess.TimeoutExpired:
            ok, tail = False, f"TIMEOUT after {timeout}s"
        dt = time.time() - t0
        rows.append((f.name, "PASS" if ok else "FAIL", f"{dt:.1f}s", tail))
        any_failed |= not ok
        print(f"[{'PASS' if ok else 'FAIL'}] {f.name} ({dt:.1f}s) {tail}", flush=True)

    w = max(len(r[0]) for r in rows) + 2
    print("\n" + "=" * (w + 40))
    for name, status, dur, tail in rows:
        print(f"{name:<{w}} {status:<6} {dur:<8} {tail}")
    print("=" * (w + 40))

    if args.report:
        def counts(tail: str) -> dict:
            out = {}
            for num, kind in re.findall(r"(\d+) (passed|failed|skipped|error)", tail):
                out[kind] = int(num)
            return out

        try:
            commit = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True
            ).stdout.strip()
            dirty = bool(
                subprocess.run(
                    ["git", "status", "--porcelain"], cwd=REPO, capture_output=True, text=True
                ).stdout.strip()
            )
        except OSError:
            commit, dirty = "unknown", True
        report = {
            "timestamp": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            # the audited tree: report is only meaningful against this commit
            "commit": commit,
            "dirty_tree": dirty,
            "total_passed": sum(counts(r[3]).get("passed", 0) for r in rows),
            "total_failed": sum(counts(r[3]).get("failed", 0) for r in rows)
            + sum(1 for r in rows if r[1] == "FAIL" and not counts(r[3])),
            "files": [
                {
                    "file": name,
                    "status": status,
                    "seconds": float(dur.rstrip("s")),
                    **counts(tail),
                    "summary": tail,
                }
                for name, status, dur, tail in rows
            ],
        }
        Path(args.report).write_text(json.dumps(report, indent=1) + "\n")
        print(f"report written to {args.report}")
    sys.exit(1 if any_failed else 0)


if __name__ == "__main__":
    main()
