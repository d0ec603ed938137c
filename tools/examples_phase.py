#!/usr/bin/env python3
"""Run `chip_smoke.py`'s examples phase alone, several times in a row.

    python3 tools/examples_phase.py [--runs 3]

Runs on one card, from the repository root.  Builds the kernels, shares
the child processes' bytecode and takes the reference's precision
settings as `chip_smoke.py` does (`child_bytecode_cache`), then runs
`chip_smoke.examples_path` `--runs` times in one process, each through
`chip_smoke.AcqPlanRecorder` (a fused-EI launch that misses the committed
plan table fails the run).  Each run prints the phase's own lines (one a
run of an example: serve_cluster's carry each client's failover retries,
the kill-to-reconciled seconds `revive_s` and the workers' start stages,
`worker_starts`, the standby's last), then
`{"examples_phase_run": i, "seconds": ...}`.  Stops at the first run that
fails: exit code 1.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=3)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("examples_phase: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.gp import resolve_device
    from repro_torch.kernels import _build
    cs.child_bytecode_cache()
    dev = resolve_device("cuda")
    cs.emit({"part": "device", "nvidia_smi": cs.nvidia_smi_line(),
             "build_seconds": _build.build()})
    recorder = cs.AcqPlanRecorder(None)
    for i in range(a.runs):
        gc.collect()        # the last run's tensors, before its peak is read
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            recorder.run(f"examples {i}", cs.examples_path, dev)
        except Exception:
            traceback.print_exc()
            print(json.dumps({"examples_phase_run": i, "failed": True,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            return 1
        print(json.dumps({"examples_phase_run": i, "failed": False,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
