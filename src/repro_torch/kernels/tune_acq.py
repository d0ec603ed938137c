"""Race the fused EI's tiles on the card and write the plan table.

    python -m repro_torch.kernels.tune_acq --keys KEYS.json [--out PATH]

KEYS.json holds the fused-EI launches that the paths of `chip_smoke.py`
make, by plan key (plan_rows, n, d, form) and study count, as
`REPRO_ACQ_AUTOTUNE=off python3 chip_smoke.py --acq-keys KEYS.json`
records them.  For each key every candidate of `acq.candidates` (R = 4,
8 and 16 of `csrc/acq.cu`, each at 1 to k_tiles / `acq.MIN_SLICE_TILES`
k-slices, the heuristic among them) is timed by device time
(torch.profiler; a launch is host-bound, so events would time the host)
at every study count the key was launched with, and at S = 1 and
S = `STUDIES` for the record, all candidates in turns in one profiling
session, on `key_inputs` (refactored standardized states made from a
numpy seed; a restart shard's launch is timed at the full `plan_rows`).
Each candidate is also held to the plain version on `HELD_STATES`
seeded states (`held_states`); only a candidate that holds as many as
the heuristic's plan may win.  The winner has the least device time over
the recorded launches (each study count's time times its launches; the
heuristic wins a tie): one plan serves every study count of a key, and a
key launched only at S = 1 is raced at S = 1 alone.  The table (default
`acq.PLANS_PATH`, `acq_plans.json`) records the card (nvidia-smi's name
and power limit), the torch and CUDA versions, the sha256 of
`csrc/acq.cu`, and per key its launches, every candidate's times and
held states, the winner, the heuristic and the digests of the winner's
outputs on those inputs (`entry_digests`, which
`chip_smoke.py` reproduces: a digest that differs means the table is
stale after a kernel edit, and this script is run again).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core import gp
from repro_torch.kernels import _build, acq

STUDIES = 16      # the engine's S; every key is also timed at 1 and STUDIES
REPS = 20         # launches of each candidate a session, in turns
SEED = 0
HELD_STATES = 6   # seeded states each candidate is held to the plain version on
TOL_EI = dict(rtol=1e-4, atol=1e-5)    # the fused EI's tolerance


def source_sha256() -> str:
    """sha256 of `csrc/acq.cu`, the source the table was raced on."""
    return hashlib.sha256((_build.CSRC / "acq.cu").read_bytes()).hexdigest()


def digest(*outs: torch.Tensor) -> str:
    """sha256 of the outputs' bits, in order (-0 read as +0), 16 hex."""
    flat = torch.cat([o.reshape(-1) for o in outs])
    return hashlib.sha256(torch.where(flat == 0, 0.0, flat).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def key_masks(d: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixed form's (d,) type masks for a key: the first two thirds of
    the coordinates continuous (at least one), the rest categorical."""
    cont = (torch.arange(d, device=dev) < max(1, 2 * d // 3)).float()
    return cont, 1.0 - cont


def key_inputs(plan_rows: int, n: int, d: int, mixed: bool, studies: int,
               seed: int = SEED, device="cuda") -> list:
    """Operands of one fused-EI launch on `studies` studies (a leading
    axis) of `plan_rows` candidates against n_max = n: each study a
    refactored state of n - n // 16 points with standardized values (a
    smooth function of the points), its candidates uniform on the unit
    cube, and the hoisted A = li^T li, active mask and shift, as the
    ascent launches them; the mixed form's (studies, d) masks
    (`key_masks`) appended.  Numpy draws from `[seed, plan_rows, n, d,
    mixed]`, so study 0 is the same for any `studies`."""
    from repro_torch.core import gp
    from repro_torch.core.kernels import make_mixed_kernel, matern52
    dev = torch.device(device)
    rng = np.random.default_rng([seed, plan_rows, n, d, int(mixed)])
    n_act = max(1, n - n // 16)
    cm, km = key_masks(d, dev)
    kern = make_mixed_kernel(cm, km) if mixed else matern52
    lanes = []
    for _ in range(studies):
        x = rng.uniform(size=(n_act, d)).astype(np.float32)
        y = np.sin(3.0 * x).sum(-1) + 0.1 * rng.standard_normal(n_act)
        y = ((y - y.mean()) / y.std()).astype(np.float32)
        st = gp.init_state(gp.GPConfig(n_max=n, dim=d, device=str(dev)))
        st.x_buf[:n_act] = torch.from_numpy(x).to(dev)
        st.y_buf[:n_act] = torch.from_numpy(y).to(dev)
        st = gp.refactor(dataclasses.replace(st, n=n_act), kern)
        amask = (torch.arange(n, device=dev) < n_act).float()
        ymean = st.y_buf[:n_act].mean()
        shift = ymean - st.y_buf[:n_act].max() - 0.01
        xc = torch.from_numpy(rng.uniform(size=(plan_rows, d))
                              .astype(np.float32)).to(dev)
        lanes.append((xc, st.x_buf, amask, st.alpha,
                      st.li_buf.T @ st.li_buf, st.params.sigma2,
                      st.params.rho, shift))
    args = [torch.stack([torch.as_tensor(lane[i], device=dev)
                         for lane in lanes]).contiguous()
            for i in range(len(lanes[0]))]
    if mixed:
        args += [m.expand(studies, d).contiguous() for m in (cm, km)]
    return args


def lane(args: list, s: int) -> list:
    """Study s's operands of a stacked launch, without the study axis."""
    return [a[s] for a in args]


def launch(args: list, mixed: bool, config: acq.AcqTileConfig):
    """One fused-EI launch of `args` (`key_inputs`' layout) on `config`."""
    if mixed:
        return acq.fused_ei_grad_mixed_cuda(*args, config=config)
    return acq.fused_ei_grad_cuda(*args, config=config)


def device_times(fns, reps: int = REPS) -> list[float]:
    """Median device ms of each fn's one fused-EI kernel: every fn once to
    warm up, then `reps` rounds of all fns in turns under one
    torch.profiler session, the kernels matched to the fns in launch
    order.  A session that records another number of fused-EI kernels
    than were launched (a session now and then drops some or all of its
    device events) is run again, up to 3 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    want = reps * len(fns)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and "fused_ei_grad_kernel" in e.name)
        if len(spans) == want:
            break
    else:
        raise RuntimeError(f"tune_acq: {len(spans)} fused-EI kernels "
                           f"profiled, {want} launched, in 3 sessions")
    us = [end - start for start, end in spans]
    return [statistics.median(us[i::len(fns)]) / 1e3 for i in range(len(fns))]


def plain(args: list, mixed: bool):
    """The plain version (`acq.ei_grad_torch`) of one study's operands in
    `key_inputs`' layout, in their dtype."""
    if not mixed:
        return acq.ei_grad_torch(*args)
    x, x_buf, *rest, cm, km = args
    xc, xbc, xk, xbk = acq.split_rows(x, x_buf, cm, km)
    return acq.ei_grad_torch(xc, xbc, *rest, xk=xk, xbk=xbk)


def held_states(key: tuple, configs, states: int = HELD_STATES,
                seed: int = SEED) -> list[dict]:
    """Each config's fused EI on `states` seeded states of the key (one
    launch, a state a lane), held state by state to the plain version:
    ei and gradient each within TOL_EI of it, or no further from a
    float64 evaluation than twice the plain version's own error.  The
    kernel sums U over its k-slices before any column sum, so a k-split
    holds as many states as one slice of its R (`chip_smoke.py` checks
    the table's counts).  Per config: "held" (the states held) and, by
    state, the gradient's float64 error over the plain version's."""
    plan_rows, n, d, form = key
    mixed = form == "mixed"
    args = key_inputs(plan_rows, n, d, mixed, states, seed)
    refs = [(plain(lane(args, i), mixed),
             plain([a.double() for a in lane(args, i)], mixed))
            for i in range(states)]
    out = []
    for cfg in configs:
        ei, grad = launch(args, mixed, cfg)
        held, ratio = [], []
        for i, (p32, p64) in enumerate(refs):
            ok = True
            for k, p, e in zip((ei[i], grad[i]), p32, p64):
                err = float((k.double() - e).abs().max())
                err_plain = float((p.double() - e).abs().max())
                ok &= bool(torch.allclose(k, p, **TOL_EI)) \
                    or err <= 2.0 * err_plain
            held.append(ok)
            ratio.append(err / max(err_plain, 1e-300))
        out.append({"held": held, "grad_err_over_plain": ratio})
    return out


def entry_digests(entry: dict, studies: int, seed: int) -> dict:
    """Digests of (ei, grad) of an entry's plan on its key's inputs: the
    S = `studies` launch and the S = 1 launch of study 0."""
    mixed = entry["form"] == "mixed"
    cfg = acq.AcqTileConfig(entry["rows"], entry["tiles_per_slice"], True)
    args = key_inputs(entry["plan_rows"], entry["n"], entry["d"], mixed,
                      studies, seed)
    return {"s1": digest(*launch(lane(args, 0), mixed, cfg)),
            f"s{studies}": digest(*launch(args, mixed, cfg))}


def plan_times(key: tuple, configs, sizes=(1, STUDIES), reps: int = REPS,
               seed: int = SEED) -> list[dict]:
    """Device ms of each config at each study count of `sizes` on the
    key's inputs (the first S studies of one draw), the configs in
    turns: one {"s<S>_ms": ms} dict a config."""
    plan_rows, n, d, form = key
    mixed = form == "mixed"
    many = key_inputs(plan_rows, n, d, mixed, max(sizes), seed)
    out = [{} for _ in configs]
    for s in sorted(sizes):
        args = lane(many, 0) if s == 1 else [a[:s] for a in many]
        ms = device_times([lambda c=c: launch(args, mixed, c)
                           for c in configs], reps)
        for o, t in zip(out, ms):
            o[f"s{s}_ms"] = t
    return out


def load_launches(path: str) -> dict[tuple, dict[int, int]]:
    """A `chip_smoke.py --acq-keys` record as {key: {studies: launches}}."""
    with open(path) as f:
        rows = json.load(f)["launches"]
    out: dict[tuple, dict[int, int]] = {}
    for *key, studies, count in rows:
        by_s = out.setdefault(tuple(key), {})
        by_s[studies] = by_s.get(studies, 0) + count
    return out


def cost_ms(times: dict, launches: dict[int, int]) -> float:
    """Device ms of a key's recorded launches on one plan."""
    return sum(c * times[f"s{s}_ms"] for s, c in launches.items())


def tune_key(key: tuple, launches: dict[int, int], studies: int = STUDIES,
             reps: int = REPS, seed: int = SEED) -> dict:
    """Race every candidate of one key on its recorded launches
    ({studies: launches}) and return its table entry."""
    plan_rows, n, d, form = key
    cands = acq.candidates(plan_rows, n, d, form == "mixed")
    times = plan_times(key, cands, sorted({1, studies, *launches}), reps,
                       seed)
    k_tiles = -(-n // acq.TK)
    rows = [{"rows": c.rows, "tiles_per_slice": c.tiles_per_slice,
             "slices": -(-k_tiles // c.tiles_per_slice), **t,
             "cost_ms": cost_ms(t, launches)} for c, t in zip(cands, times)]
    for row, h in zip(rows, held_states(key, cands, HELD_STATES, seed)):
        row["held"] = sum(h["held"])
    admitted = [r for r in rows if r["held"] >= rows[0]["held"]]
    win = min(admitted, key=lambda r: r["cost_ms"])
    entry = {"plan_rows": plan_rows, "n": n, "d": d, "form": form,
             "rows": win["rows"], "tiles_per_slice": win["tiles_per_slice"],
             "slices": win["slices"],
             "ms": {k: v for k, v in win.items()
                    if k.startswith("s") and k.endswith("_ms")},
             "cost_ms": win["cost_ms"],
             "launches": {str(s): c for s, c in sorted(launches.items())},
             "heuristic": rows[0],
             "candidates": rows}
    entry["digest"] = entry_digests(entry, studies, seed)
    return entry


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--keys", required=True,
                   help="JSON from `chip_smoke.py --acq-keys`")
    p.add_argument("--out", default=str(acq.PLANS_PATH))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_acq: CUDA is not available", file=sys.stderr)
        return 1
    if not acq._acq_autotune_enabled():
        print("tune_acq: REPRO_ACQ_AUTOTUNE is off", file=sys.stderr)
        return 1
    gp.reference_precision()
    launches = load_launches(a.keys)
    _build.build(("acq",))
    table = {"card": nvidia_smi_line(),
             "device": torch.cuda.get_device_name(0),
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "acq_cu_sha256": source_sha256(), "studies": STUDIES,
             "reps": REPS, "seed": SEED, "held_states": HELD_STATES,
             "entries": []}
    for key in sorted(launches):
        entry = tune_key(key, launches[key], STUDIES, REPS, SEED)
        table["entries"].append(entry)
        print(json.dumps({k: entry[k] for k in entry if k != "candidates"}),
              flush=True)
    with open(a.out, "w") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    print(json.dumps({"tune_acq": a.out, "keys": len(launches),
                      "card": table["card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
