#!/usr/bin/env python3
"""Where the card's neural-basis refit leaves float32, stage by stage.

    python3 tools/neural_refit_drift.py [--plans table,heuristic,r8x2,...]
        [--ops] [--out F]

Runs on one card, from the repository root.  For each plan of the float
engine key (48, 1024, 5, float) of the fused EI (`table`: the committed
`acq_plans.json`'s; `heuristic`: the kernel's heuristic, 6 k-slices;
`r<R>x<S>`: tile R at S k-slices, any candidate of the key, such as
`r8x2`), it drives `chip_smoke.py`'s float engine phase, its profile round
and its neural phase on that plan, keeps the escalated slot's inputs (the
promotion's ledger, costs and params, the 40 absorbs) and reports:

  * `rule`: the neural phase's verdict, and the card's state against a
    CPU float64 replay by `chip_smoke.held_f64_rule` (2x the worst error
    of the CPU float32 replays in the `NEURAL_ORDERS` contraction orders,
    or the head's kappa bound) and by the rule it replaced (2x the plain
    CPU float32 replay's error, or the kappa bound: `old_rule_fails`);
  * `ops` (with `--ops`, the first plan only): each op of one refit
    step, and the head's rebuild,
    on float32 inputs rounded from a float64 evaluation at the promotion's
    params and at the card's final params, computed on the card and on
    the CPU in float32 against float64: the error over the op's float32
    bound (a GEMM's or a sum's gamma_K |a||b|, K u / (1 - K u) with u =
    2^-24) and in units of the output's last place; tanh also evaluated
    in float64 and rounded;
  * `trajectory`: the 40 absorbs replayed with one stage at a time moved
    to float64 on the card (forward GEMMs, the masked MSE's sum,
    autograd's backward GEMMs, the Adam step, the head's rebuild), the CPU
    float32 replays in each contraction order, the CPU replay from params
    one ulp away, and the card's replay with TF32 on and with every GEMM
    operand rounded to TF32 (`chip_smoke.Tf32Operands`, the rule's
    negative control): each one's error against float64 and the keys on
    which it fails the rule (and the old rule).

The MLP's tanh is the package's own (`neural_basis._tanh`: float64,
rounded), so the trajectory has no tanh stage.  Each part is one
JSON line on standard output, appended to `--out`
(`chiprun_out/neural_refit_drift.jsonl` by default).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

U32 = 2.0 ** -24
FLOAT_KEY = (48, 1024, 5, False)
GEMMS = ("aten.mm.default", "aten.mv.default")


def plan_config(plan: str):
    """The fused EI's config for a plan name of `--plans`, or None for
    the committed table's (the package's own lookup)."""
    from repro_torch.kernels import acq
    if plan == "table":
        return None
    if plan == "heuristic":
        return acq.heuristic_config(*FLOAT_KEY[:2])
    rows, slices = (int(v) for v in plan.removeprefix("r").split("x"))
    k_tiles = -(-FLOAT_KEY[1] // acq.TK)
    cfg = acq.AcqTileConfig(rows, -(-k_tiles // slices), True)
    if cfg not in acq.candidates(*FLOAT_KEY) or \
            -(-k_tiles // cfg.tiles_per_slice) != slices:
        raise ValueError(f"{plan}: not a candidate of {FLOAT_KEY}")
    return cfg


class Stage(TorchDispatchMode):
    """Moves one stage of a refit step to float64: the ops of `kinds`
    (by aten name) while the refit's gradient is computed, in the forward
    pass (`grad_enabled` True), the backward (False) or both (None).  Each
    float32 operand is widened, the op run, and its float outputs rounded
    back to float32.  Counts the ops it moved by pass."""

    def __init__(self, kinds, grad_enabled):
        super().__init__()
        self.kinds, self.grad_enabled = set(kinds), grad_enabled
        self.active, self.moved = False, {"forward": 0, "backward": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        on = torch.is_grad_enabled()
        f32 = any(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                  for a in args)
        if not (self.active and f32 and str(func) in self.kinds and
                self.grad_enabled in (None, on)):
            return func(*args, **kwargs)
        self.moved["forward" if on else "backward"] += 1
        wide = [a.double() if isinstance(a, torch.Tensor)
                and a.dtype == torch.float32 else a for a in args]
        out = func(*wide, **kwargs)
        return out.float() if out.dtype == torch.float64 else out


@contextlib.contextmanager
def patched(nb, stage: str | None, mode: Stage | None):
    """Moves the Adam step or the head's rebuild to float64 (widen the
    inputs, round the outputs), or turns `mode` on inside the gradient."""
    saved = {k: getattr(nb, k) for k in ("_refit_grad", "_adam_step",
                                         "_rebuild_cache")}

    def grad(*args):
        mode.active = True
        try:
            return saved["_refit_grad"](*args)
        finally:
            mode.active = False

    def adam(params, m, v, g, t, lr, dtype):
        wide = [[x.double() for x in xs] for xs in (params, m, v, g)]
        outs = saved["_adam_step"](*wide, t, lr, dtype)
        return tuple([x.float() for x in xs] for xs in outs)

    def rebuild(state, ncfg):
        wide = nb._replace(state, **{
            k: getattr(state, k).double() for k in nb.FIELDS
            if k not in nb.COUNTERS})
        out = saved["_rebuild_cache"](wide, ncfg)
        return nb._replace(out, **{k: getattr(out, k).float()
                                   for k in nb.FIELDS
                                   if k not in nb.COUNTERS})

    if mode is not None:
        nb._refit_grad = grad
    if stage == "adam":
        nb._adam_step = adam
    if stage == "rebuild":
        nb._rebuild_cache = rebuild
    try:
        with mode if mode is not None else contextlib.nullcontext():
            yield
    finally:
        for k, v in saved.items():
            setattr(nb, k, v)


STAGES = {   # stage: (aten ops, forward pass / backward / both) or a patch
    "forward GEMMs": (GEMMS, True),
    "masked MSE sum": (("aten.sum.default",), True),
    "backward GEMMs": (GEMMS, False),
    "Adam step": "adam",
    "head rebuild": "rebuild",
}


def errors(st, exact) -> dict:
    return {k: float((getattr(st, k).double().cpu()
                      - getattr(exact, k)).abs().max())
            for k in ("chol", "w_y", "w_c", "s2")}


def verdict(st, cpu32s, exact, probes, ncfg) -> dict:
    """The errors, the keys on which `held_f64_rule` fails, and those on
    which the old rule (2x the plain replay, `cpu32s[0]`) fails."""
    held = cs.held_neural_state(st, cpu32s, exact, probes, ncfg)["held"]
    return {"errors": errors(st, exact),
            "fails": sorted(k for k, h in held.items() if not h["held_by"]),
            "old_rule_fails": sorted(
                k for k, h in held.items()
                if h["card_err"] > max(2.0 * h["cpu32_errs"][0], h["bound"]))}


def last_place(x: torch.Tensor) -> torch.Tensor:
    """The spacing of float32 at |x| (x float64, on the CPU)."""
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, np.inf)) - a).double()


def op_table(start, card, ncfg, dev) -> list[dict]:
    """Each op of one refit step and the head's rebuild, at the
    promotion's params and at the card's final params, on the card and
    on the CPU in float32 against float64 from the same float32 inputs."""
    from repro_torch.core import neural_basis as nb
    xs, ys, logcs, p0 = start
    x = card.x_buf.double().cpu()
    n = int(card.n)
    mask = torch.arange(card.cap) < n
    y_mean = card.y_buf.double().cpu()[:n].mean()
    targets = torch.where(mask, card.y_buf.double().cpu() - y_mean, 0.0)
    nf = float(n)
    rows = []
    for at, params in (("promotion", {k: v.double() for k, v in p0.items()}),
                       ("final", {k: getattr(card, k).double().cpu()
                                  for k in nb.PARAMS})):
        w1, b1, w2, b2, w3, b3 = (params[k] for k in nb.PARAMS)
        # The float64 chain; each op below reads its inputs rounded to f32.
        z1 = x @ w1
        h = torch.tanh(z1 + b1)
        z2 = h @ w2
        f = torch.tanh(z2 + b2)
        pred = f @ w3 + b3
        err = torch.where(mask, pred - targets, 0.0)
        dpred = 2.0 * err / nf
        dz2 = torch.outer(dpred, w3) * (1.0 - f * f)
        dh = dz2 @ w2.T
        dz1 = dh * (1.0 - h * h)
        ops = {
            "x @ w1": ("gemm", torch.mm, (x, w1)),
            "h @ w2": ("gemm", torch.mm, (h, w2)),
            "f @ w3": ("gemm", torch.mv, (f, w3)),
            "tanh": ("elementwise", torch.tanh, (z1 + b1,)),
            "tanh in float64, rounded": (
                "elementwise", lambda a: torch.tanh(a.double()).to(a.dtype),
                (z1 + b1,)),
            "masked MSE sum": ("sum", torch.sum, (err * err,)),
            "backward x^T @ dz1": ("gemm", torch.mm, (x.T.contiguous(), dz1)),
            "backward h^T @ dz2": ("gemm", torch.mm, (h.T.contiguous(), dz2)),
            "backward dz2 @ w2^T": ("gemm", torch.mm,
                                    (dz2, w2.T.contiguous())),
            "backward f^T @ dpred": ("gemm", torch.mv,
                                     (f.T.contiguous(), dpred)),
            "backward sum(dz1, 0)": ("sum", lambda a: a.sum(0), (dz1,)),
            "tanh_backward": ("elementwise",
                              torch.ops.aten.tanh_backward.default,
                              (dh, h)),
        }
        for name, (kind, fn, args) in ops.items():
            a32 = [a.float() for a in args]
            exact = fn(*[a.double() for a in a32])
            outs = {"card": fn(*[a.to(dev) for a in a32]).double().cpu(),
                    "cpu": fn(*a32).double()}
            if kind == "gemm":
                k = a32[0].shape[-1]
                bound = k * U32 / (1 - k * U32) * fn(
                    *[a.double().abs() for a in a32])
            elif kind == "sum":
                k = a32[0].shape[0]
                bound = k * U32 / (1 - k * U32) * fn(a32[0].double().abs())
            else:
                bound = None
            row = {"at": at, "op": name, "kind": kind}
            for where, o in outs.items():
                e = (o - exact).abs()
                row[f"{where}_max_err"] = float(e.max())
                row[f"{where}_ulps"] = float((e / last_place(exact)).max())
                if bound is not None:
                    row[f"{where}_over_bound"] = float(
                        (e / bound.clamp(min=1e-300)).max())
            rows.append(row)
        # The Adam step from this point: g the float64 gradient, m and v
        # one step of it, rounded to float32 like the rest.
        with torch.enable_grad():
            ps = [params[k].clone().requires_grad_(True) for k in nb.PARAMS]
            hh = torch.tanh(x @ ps[0] + ps[1])
            ff = torch.tanh(hh @ ps[2] + ps[3])
            e = torch.where(mask, ff @ ps[4] + ps[5] - targets, 0.0)
            g = torch.autograd.grad(torch.sum(e * e) / nf, ps)
        p32 = [params[k].float() for k in nb.PARAMS]
        g32 = [t.float() for t in g]
        m32 = [0.1 * t for t in g32]
        v32 = [0.001 * t * t for t in g32]
        exact = nb._adam_step([t.double() for t in p32],
                              [t.double() for t in m32],
                              [t.double() for t in v32],
                              [t.double() for t in g32], 1, ncfg.refit_lr,
                              torch.float32)[0]
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            new = nb._adam_step([t.to(d) for t in p32], [t.to(d) for t in m32],
                                [t.to(d) for t in v32], [t.to(d) for t in g32],
                                1, ncfg.refit_lr, torch.float32)[0]
            ulps = max(float(((a.double().cpu() - b).abs()
                              / last_place(b)).max())
                       for a, b in zip(new, exact))
            if where == "card":
                row = {"at": at, "op": "Adam step", "kind": "elementwise"}
            row[f"{where}_ulps"] = ulps
        rows.append(row)
        # The head's rebuild on these params (the card's ledger).
        st32 = nb._replace(card, **{k: params[k].float().to(dev)
                                    for k in nb.PARAMS})
        st64 = nb._replace(st32, **{
            k: getattr(st32, k).double().cpu() for k in nb.FIELDS
            if k not in nb.COUNTERS}, n=st32.n.cpu(),
            since_refit=st32.since_refit.cpu())
        exact = nb._rebuild_cache(st64, ncfg)
        cpu32 = nb._replace(st64, **{
            k: getattr(st64, k).float() for k in nb.FIELDS
            if k not in nb.COUNTERS})
        row = {"at": at, "op": "head rebuild", "kind": "solve"}
        for where, st in (("card", nb._rebuild_cache(st32, ncfg)),
                          ("cpu", nb._rebuild_cache(cpu32, ncfg))):
            row[f"{where}_errors"] = errors(st, exact)
        rows.append(row)
    return rows


def trajectory(start, absorbs, card, exact, cpu32s, probes, ncfg, dev
               ) -> list[dict]:
    from repro_torch.core import neural_basis as nb
    f32 = torch.float32

    def row(name, st, **more):
        return {"run": name, **more,
                **verdict(st, cpu32s, exact, probes, ncfg)}

    def replay(start=start, device=dev, mode=None):
        return cs.neural_replay(start, absorbs, ncfg, f32, device, mode)

    plain = replay()
    rows = [row("card (the engine's state)", card),
            row("card replay", plain, equal_to_engine=all(
                torch.equal(getattr(plain, k), getattr(card, k))
                for k in nb.FIELDS))]
    for name, how in STAGES.items():
        mode = Stage(*how) if isinstance(how, tuple) else None
        with patched(nb, how if isinstance(how, str) else None, mode):
            st = replay()
        rows.append(row(f"card, {name} in float64", st,
                        moved=mode.moved if mode else None))
    for c, st in zip(cs.NEURAL_ORDERS, cpu32s):
        rows.append(row(f"cpu float32, {c} chunks", st))
    xs, ys, logcs, params = start
    bumped = dict(params, w1=torch.nextafter(params["w1"], torch.full_like(
        params["w1"], np.inf)))
    rows.append(row("cpu float32, w1 one ulp up",
                    replay((xs, ys, logcs, bumped), "cpu")))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st = replay()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rows.append(row("card, TF32 on (cuBLAS)", st))
    rows.append(row("card, GEMM operands rounded to TF32",
                    replay(mode=cs.Tf32Operands())))
    return rows


def run_plan(dev, plan: str, ops: bool, out) -> None:
    from repro_torch.kernels import acq
    acq._ACQ_TUNE_CACHE.clear()
    cfg = plan_config(plan)
    if cfg is not None:
        acq._ACQ_TUNE_CACHE[FLOAT_KEY] = cfg
    used = acq.acq_tile_config(*FLOAT_KEY)
    t0 = time.perf_counter()
    _, eng, studies, units, _ = cs.engine_path(dev, False)
    cs.profile_engine("engine", eng, studies, units)
    kept = {}
    neural_replay = cs.neural_replay

    def keep(start, absorbs, ncfg, *args, **kw):
        kept.setdefault("inputs", (start, absorbs, ncfg))
        return neural_replay(start, absorbs, ncfg, *args, **kw)

    cs.neural_replay = keep
    try:
        cs.neural_path(dev, eng, studies, False)
        phase = "held"
    except AssertionError as e:
        phase = f"failed: {str(e)[:400]}"
    finally:
        cs.neural_replay = neural_replay
    slot = next(s for s in range(eng.n_studies) if eng.tier(s))
    card = eng.nb_state(slot)
    start, absorbs, ncfg = kept["inputs"]
    exact = cs.neural_replay(start, absorbs, ncfg, torch.float64)
    cpu32s = cs.cpu32_replays(start, absorbs, ncfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    probes = torch.rand((cs.NEURAL_PROBES, eng.dim), generator=gen,
                        device=dev)
    held = cs.held_neural_state(card, cpu32s, exact, probes, ncfg)
    emit(out, {"plan": plan, "part": "rule",
               "config": {"rows": used.rows,
                          "tiles_per_slice": used.tiles_per_slice,
                          "measured": used.measured},
               "neural_phase": phase, "slot": slot, **held,
               "old_rule_fails": verdict(card, cpu32s, exact, probes,
                                         ncfg)["old_rule_fails"],
               "seconds": time.perf_counter() - t0})
    if ops:
        for r in op_table(start, card, ncfg, dev):
            emit(out, {"plan": plan, "part": "ops", **r})
    for r in trajectory(start, absorbs, card, exact, cpu32s, probes, ncfg,
                        dev):
        emit(out, {"plan": plan, "part": "trajectory", **r})
    del eng, card
    torch.cuda.empty_cache()


def emit(out, line: dict) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    out.write(text + "\n")
    out.flush()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plans", default="table,heuristic",
                   help="comma-separated: table, heuristic or r<R>x<S>")
    p.add_argument("--ops", action="store_true",
                   help="the op-by-op table on the first plan")
    p.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "neural_refit_drift.jsonl"))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("neural_refit_drift: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core.gp import resolve_device
    from repro_torch.kernels import _build
    dev = resolve_device("cuda")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    plans = a.plans.split(",")
    for plan in plans:
        plan_config(plan)           # a name that is no plan fails first
    with open(a.out, "a") as out:
        emit(out, {"part": "device", "nvidia_smi": cs.nvidia_smi_line(),
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "build_seconds": _build.build()})
        for i, plan in enumerate(plans):
            run_plan(dev, plan, a.ops and i == 0, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
