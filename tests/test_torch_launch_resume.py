"""The port's launcher (`python -m repro_torch.launch.train`) at
--mesh-shape 2x2 on four gloo CPU ranks (one subprocess a rank,
rendezvous through a file in tmp_path): checkpointed at step 3 of 6, a
resume at 2x2 gives the same losses bit for bit (the same ranks sum in
the same order), a resume at 1x1 in this process within 1e-5 of each
loss; SIGTERM sent to one rank makes every rank checkpoint the same step
and exit 3."""
import signal
import sys

from _torch_launch_ranks import finish as _finish
from _torch_launch_ranks import start as _start

from repro_torch import checkpoint as ckpt
from repro_torch.launch import train

TOL = 1e-5

def _launch(tmp_path, tag, ckpt_dir, steps=6, extra=()):
    store = tmp_path / f"{tag}.store"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "tiny-lm", "--reduced", "--mesh-shape", "2x2", "--device", "cpu",
           "--steps", str(steps), "--seq-len", "32", "--log-every", "1",
           "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "3", "--dist-init",
           f"file://{store}", *extra]
    return _start(cmd, 4)


def _losses(out: str) -> dict[int, float]:
    got = {}
    for line in out.splitlines():
        if line.startswith("[train] step="):
            step, loss = line.split()[1:3]
            got[int(step.split("=")[1])] = float(loss.split("=")[1])
    return got


def test_launcher_resumes_and_stops_on_sigterm(tmp_path):
    """Two 2x2 runs side by side: A, 6 steps checkpointed at 3 and 6, and
    T, which rank 1 is sent SIGTERM in after rank 0 logged step 2.  Then
    A's step-3 checkpoint resumed at 2x2 (ranks) and at 1x1 (here)."""
    import shutil
    a, t = tmp_path / "a", tmp_path / "t"
    run_a = _launch(tmp_path, "a", a)
    run_t = _launch(tmp_path, "t", t, steps=400)
    first = []
    for line in run_t[0].stdout:
        first.append(line)
        if line.startswith("[train] step=2 "):
            break
    run_t[1].send_signal(signal.SIGTERM)
    outs_t = _finish(run_t, codes=(3,))
    outs_t[0] = "".join(first) + outs_t[0]
    said = set()
    for out in outs_t:
        lines = [ln for ln in out.splitlines() if "SIGTERM" in ln]
        assert len(lines) == 1, out[-2000:]
        said.add(lines[0])
    assert len(said) == 1, said                 # every rank: one step
    step = int(said.pop().split("step ")[1].split()[0])
    assert 3 <= step < 400
    assert ckpt.latest_step(str(t)) == step

    whole = _losses(_finish(run_a)[0])
    assert sorted(whole) == list(range(6))
    assert ckpt.latest_step(str(a)) == 6
    b, c = tmp_path / "b", tmp_path / "c"
    for d in (b, c):
        shutil.copytree(a / "step_000000003", d / "step_000000003")
    run_b = _launch(tmp_path, "b", b)
    one = train.run(train.parse_args([
        "--arch", "tiny-lm", "--reduced", "--device", "cpu", "--steps", "6",
        "--seq-len", "32", "--log-every", "1", "--ckpt-dir", str(c)]))
    resumed = _losses(_finish(run_b)[0])
    # Rank 0 prints 4 decimals: the 2x2 resume must print A's losses
    # exactly; the 1x1 run's floats lie within 1e-5 of them, or within
    # the print's rounding (5e-5).
    assert resumed == {s: whole[s] for s in range(3, 6)}
    assert one["start"] == 3 and one["steps"] == [3, 4, 5]
    for s, loss in zip(one["steps"], one["losses"]):
        assert abs(loss - whole[s]) <= max(TOL * abs(whole[s]), 5e-5), s
