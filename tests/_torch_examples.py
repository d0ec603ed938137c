"""Helpers of the example tests: the JAX package's `examples/<name>.py`
run as subprocesses beside the port's `repro_torch.examples.<name>.main`
run in process, and the printed lines of either reduced to their shape."""
from __future__ import annotations

import os
import re
import shlex
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")
SEPARATOR = "@@ next run @@"


def start_reference(name: str, *argvs: list[str]) -> subprocess.Popen:
    """`python examples/<name>.py argv` on the CPU (JAX) for each argv in
    turn (a second run on a checkpoint directory resumes the first),
    started now and read by `reference_outputs`; the port runs
    meanwhile."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    script = f" && echo {shlex.quote(SEPARATOR)} && ".join(
        shlex.join([sys.executable, os.path.join("examples", f"{name}.py"),
                    *argv]) for argv in argvs)
    return subprocess.Popen(["bash", "-c", script], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def stop(proc: subprocess.Popen) -> None:
    """Kill a reference run still going, with every process it started
    (serve_cluster's shard workers among them)."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def reference_outputs(proc: subprocess.Popen, timeout: float = 240
                      ) -> list[str]:
    """Each run's standard output, in order."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        stop(proc)
    assert proc.returncode == 0, err[-2000:]
    return out.split(SEPARATOR + "\n")


def shape(text: str) -> list[str]:
    """The printed lines with every number as `#`, each run of spaces as
    one and none inside brackets (padding follows the numbers' widths),
    blank lines dropped."""
    lines = (" ".join(NUMBER.sub("#", ln).split())
             for ln in text.splitlines() if ln.strip())
    return [re.sub(r"\[ | \]", lambda m: m.group().strip(), ln)
            for ln in lines]


def numbers(pattern: str, text: str) -> list[tuple]:
    """Every match of `pattern` (groups converted to int or float)."""
    def num(s):
        return int(s) if re.fullmatch(r"[-+]?\d+", s) else float(s)
    return [tuple(num(g) for g in m.groups())
            for m in re.finditer(pattern, text)]
