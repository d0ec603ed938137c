"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

The same numpy arrays go through the JAX package (the reference, on the
CPU) and through `repro_torch` on the CPU, where every wrapper runs its
plain PyTorch version.  One torch thread per test process, so six xdist
workers do not oversubscribe the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")
# GP buffers (factor, inverse, alpha) of a port run against the reference's
# after the same appends and lag events, as tests/test_torch_bayesopt.py
# holds them: float32 sums in another order, compounded over the rounds.
TOL = dict(rtol=1e-4, atol=1e-4)


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (float32 unless told)."""
    return torch.from_numpy(np.array(a)).to(dtype)


def j(a) -> jax.Array:
    """numpy / torch -> jax array, float32 floats."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.float32) if a.dtype.kind == "f" else a)


def n(a) -> np.ndarray:
    """torch / jax -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def spd(rng: np.random.Generator, size: int, batch=()) -> np.ndarray:
    """Well-conditioned SPD matrices, float32."""
    a = rng.standard_normal((*batch, size, size)).astype(np.float32)
    eye = np.eye(size, dtype=np.float32)
    return (a @ np.swapaxes(a, -1, -2) / size + 2.0 * eye).astype(np.float32)


def lower_factor(rng: np.random.Generator, size: int, batch=()) -> np.ndarray:
    return np.linalg.cholesky(spd(rng, size, batch).astype(np.float64)) \
        .astype(np.float32)


def jax_state_leaves(state) -> dict[str, np.ndarray]:
    """A JAX LazyGPState as {tree-path name: numpy leaf}, the names the
    reference checkpoint store writes."""
    from repro.checkpoint.store import _flatten_with_paths
    names, leaves, _ = _flatten_with_paths(state)
    return {k: np.asarray(v) for k, v in zip(names, leaves)}


def seeded_states(rng: np.random.Generator, n0: int, dim: int, n_max: int):
    """The same seeded GP state in both packages: (jax_state, torch_state).

    Built by the reference (append_batch from its empty state, then a full
    refactor), then carried to the port bit for bit through `convert`."""
    from repro.core import gp as jgp
    from repro.core.kernels import matern52 as jmatern52
    from repro_torch import convert
    xs = rng.uniform(size=(n0, dim)).astype(np.float32)
    ys = (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0]).astype(np.float32)
    cfg = jgp.GPConfig(n_max=n_max, dim=dim, implementation="xla")
    st = jgp.append_batch(jgp.init_state(cfg), jmatern52, j(xs), j(ys),
                          implementation="xla")
    st = jgp.refactor(st, jmatern52, implementation="xla")
    return st, convert.state_from_numpy(jax_state_leaves(st), device=CPU)


def key_draws(key, restarts: int, dim: int, top_t: int = 1):
    """The draws the reference's ascent makes from one study's `key` on
    the unit cube: restart seeds (R, d) from the key, the top-t backfill
    jitter (top_t, d) from fold_in(key, 1), as numpy arrays."""
    return (np.asarray(jax.random.uniform(key, (restarts, dim),
                                          dtype=jnp.float32)),
            np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                         (top_t, dim), dtype=jnp.float32)))


def engine_draws(key, n_studies: int, restarts: int, dim: int,
                 top_t: int = 1):
    """The draws the reference's stacked engine makes from `key` (its
    vmapped ascent: study s draws from keys[s], `key_draws`), as numpy
    arrays to hand to the port: (keys, seeds (S, R, d), jitter
    (S, top_t, d))."""
    keys = jax.random.split(key, n_studies)
    seeds, jitter = zip(*(key_draws(k, restarts, dim, top_t) for k in keys))
    return keys, np.stack(seeds), np.stack(jitter)


def mirror_pool_draws(tpool, seed: int, owner=None, keys=None):
    """Make a port `StudyPool` draw what the reference's pool draws: each
    study's EI draws come from a JAX key stream that starts at
    PRNGKey(seed + i) and is split as the reference's pool splits it (one
    split a suggest, routed or batched; `key_draws` of the subkey).

    Under a gateway pass `owner(slot)` (the logical study in a slot,
    `gw._owner[slot]`): the streams then follow the logical study i, as
    the reference gateway's keys do (seeded seed + i, carried through
    eviction snapshots), not the slot; pools that pass one `keys` dict
    share the streams, so a study's keys follow it from pool to pool (the
    shards of a federation).  Returns the streams' keys (a list, or a dict
    by logical study, the caller may read)."""
    if owner is None:
        keys = [jax.random.PRNGKey(seed + i) for i in range(tpool.n_studies)]

        def who(slot):
            return slot
    else:
        keys = {} if keys is None else keys

        def who(slot):
            sid = owner(slot)
            if sid not in keys:
                keys[sid] = jax.random.PRNGKey(seed + sid)
            return sid
    restarts, dim = tpool.cfg.acq.restarts, tpool.dim

    def draw(study_id, top_t):
        sid = who(study_id)
        keys[sid], sub = jax.random.split(keys[sid])
        return tuple(torch.from_numpy(a.copy()) for a in key_draws(
            sub, restarts, dim, top_t))

    def draw_q(study_id, q):
        sid = who(study_id)
        keys[sid], sub = jax.random.split(keys[sid])
        subs = jax.random.split(sub, q)
        seeds, jitter = zip(*(key_draws(k, restarts, dim, 1) for k in subs))
        return torch.from_numpy(np.stack(seeds)), \
            torch.from_numpy(np.stack(jitter))

    tpool._draw = draw
    tpool._draw_q = draw_q
    return keys


def slot_bytes(pool, slot: int) -> dict:
    """Every leaf of one slot of a port pool as raw bytes, under the
    reference's leaf names, with the host counts: the comparison is bit
    for bit (tests/_traffic.py's `slot_bytes` for the port)."""
    from repro_torch.core import gp as gp_mod
    st = pool.engine.study_state(slot)
    out = {name: leaf.numpy().tobytes() for name, leaf in zip(
        ("x_buf", "y_buf", "l_buf", "li_buf", "alpha", "clamp_count",
         "params/sigma2", "params/rho", "params/noise2"),
        gp_mod._leaves(st))}
    out["n"], out["since_refit"] = st.n, st.since_refit
    return out


def assert_slots_equal(pool_a, slot_a, pool_b, slot_b, ctx="") -> None:
    """Two slots of port pools, every leaf bit for bit."""
    a, b = slot_bytes(pool_a, slot_a), slot_bytes(pool_b, slot_b)
    assert a.keys() == b.keys()
    for leaf in a:
        assert a[leaf] == b[leaf], f"{leaf} differs {ctx}".rstrip()


def assert_engines_match(jeng, teng, pending: dict | None = None) -> None:
    """Every study of a port engine against the reference engine's: the
    host and device counters and the clamp counts exactly, the points,
    observations and the grid-picked params bit for bit, the factor, the
    inverse and alpha at TOL.  `pending` maps a study to its count of
    fantasy rows on top (the last rows), whose points are each package's
    own picks and whose observations are liar values: those rows are held
    at TOL."""
    pending = pending or {}
    assert jeng.n_studies == teng.n_studies
    np.testing.assert_array_equal(teng.clamp_counts(), jeng.clamp_counts())
    np.testing.assert_array_equal(n(teng.state.n), n(jeng.state.n))
    np.testing.assert_array_equal(n(teng.state.since_refit),
                                  n(jeng.state.since_refit))
    for s in range(jeng.n_studies):
        js, ts = jeng.study_state(s), teng.study_state(s)
        assert (teng.n(s), teng.since_refit(s)) == (jeng.n(s),
                                                     jeng.since_refit(s))
        assert (ts.n, ts.since_refit) == (int(js.n), int(js.since_refit))
        real = ts.n - pending[s] if s in pending else ts.n_max
        for leaf in ("x_buf", "y_buf"):
            got, want = n(getattr(ts, leaf)), n(getattr(js, leaf))
            np.testing.assert_array_equal(got[:real], want[:real],
                                          err_msg=f"study {s} {leaf}")
            np.testing.assert_allclose(got[real:], want[real:], **TOL,
                                       err_msg=f"study {s} {leaf}")
        for leaf in ("l_buf", "li_buf", "alpha"):
            np.testing.assert_allclose(n(getattr(ts, leaf)),
                                       n(getattr(js, leaf)), **TOL,
                                       err_msg=f"study {s} {leaf}")
        for p in ("sigma2", "rho", "noise2"):
            assert float(getattr(ts.params, p)) == \
                float(getattr(js.params, p)), f"study {s} {p}"


def scaled_levy(u) -> np.ndarray:
    """Levy on [-10, 10]^d, read from unit-cube rows u (..., d), at 0.05 x
    its scale, as tests/test_torch_bayesopt.py runs it: at the raw scale
    EI underflows, and in that lower tail the reference's float32 1 + erf
    leaves an artifact that its ascent follows and the port's erfc does
    not (ROADMAP queue 3, EI underflow)."""
    from repro_torch.core.levy import neg_levy
    x = torch.from_numpy(-10.0 + 20.0 * np.asarray(u, np.float32))
    return (0.05 * neg_levy(x)).numpy().astype(np.float32)


def mixed_space4():
    """A width-4 mixed space (a float, a 4-level Int, a 2-way
    Categorical), as tests/test_torch_engine_mixed.py uses."""
    from repro_torch.hpo.space import Categorical, Dim, Int, SearchSpace
    return SearchSpace((Dim("a", 0.0, 1.0), Int("k", 0, 3),
                        Categorical("c", ("p", "q"))))


def jax_space(space):
    """The reference's SearchSpace of a port SearchSpace."""
    from repro.hpo import space as jspace
    from repro_torch.hpo.space import space_to_dicts
    return jspace.space_from_dicts(space_to_dicts(space))


def kernel_pair(space=None):
    """(reference kernel, port kernel): Matérn-2.5, or the mixed kernel
    over `space`'s type masks."""
    from repro.core.kernels import make_mixed_kernel as jmixed
    from repro.core.kernels import matern52 as jmatern52
    from repro_torch.core.kernels import make_mixed_kernel, matern52
    if space is None:
        return jmatern52, matern52
    jd, td = jax_space(space).descriptor(), space.descriptor()
    return (jmixed(jd.cont_mask, jd.cat_mask),
            make_mixed_kernel(td.cont_mask, td.cat_mask))


def sine_objective(xs) -> np.ndarray:
    """The objective of `seeded_states`: sin(3 sum x) + 0.1 x_0, O(1)
    values on the unit cube."""
    xs = np.asarray(xs, np.float32)
    return (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[..., 0]).astype(np.float32)


def levy_states(xs: np.ndarray, n_max: int, space=None,
                objective=scaled_levy):
    """The same GP state over points `xs (n0, d)` in both packages: the
    reference's appends and refactor on `objective`'s values (0.05 x Levy
    unless told; Matérn, or the mixed kernel over `space`), carried to the
    port bit for bit through `convert`.  Returns (jax_state, torch_state,
    jax_kernel, torch_kernel)."""
    from repro.core import gp as jgp
    from repro_torch import convert
    jkern, tkern = kernel_pair(space)
    cfg = jgp.GPConfig(n_max=n_max, dim=xs.shape[1], implementation="xla")
    st = jgp.append_batch(jgp.init_state(cfg), jkern, j(xs),
                          j(objective(xs)), implementation="xla")
    st = jgp.refactor(st, jkern, implementation="xla")
    return (st, convert.state_from_numpy(jax_state_leaves(st), device=CPU),
            jkern, tkern)


# ---------------------------------------------------------------------------
# The LM side's serving path (tests/test_torch_lm_decode*.py)
# ---------------------------------------------------------------------------

# Every arch with `supports_decode` and no frontend: the reference test's
# nine (tests/test_models.py:55) and tiny-lm.
DECODE_ARCHS = ("tiny-lm", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                "deepseek-coder-33b", "minicpm3-4b", "granite-3-2b",
                "gemma3-4b", "zamba2-1.2b", "chameleon-34b", "xlstm-1.3b")
# Batch, prompt and decode steps of the serving tests (as the reference's).
SERVE_B, SERVE_PROMPT, SERVE_STEPS = 2, 32, 3


def lm_pair(arch: str, seed: int = 0, **changes):
    """(reference config, port config, reference params, port params):
    `arch`'s reduced config with `changes`, the reference's init carried
    to the port by tree path."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro.models import init_params as jinit_params
    from repro_torch import convert
    from repro_torch.configs import get_config
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **changes)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    jp, _ = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, convert.lm_params_from_numpy(
        jax_state_leaves(jp), device=CPU)


def serve_tokens(cfg, seed: int = 0) -> np.ndarray:
    """(SERVE_B, SERVE_PROMPT + SERVE_STEPS) token ids, or standard normal
    frames for a frames frontend."""
    rng = np.random.default_rng(seed)
    shape = (SERVE_B, SERVE_PROMPT + SERVE_STEPS)
    if cfg.frontend == "frames":
        return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _cache_leaves(leaves: dict) -> dict:
    return {k: np.asarray(v, np.int32 if k == "pos" else np.float32)
            for k, v in leaves.items()}


def serve_reference(jcfg, jp, toks: np.ndarray, prompt: int,
                    op_by_op: bool = False) -> list:
    """The reference's prefill of `toks[:, :prompt]` into a cache of
    `toks`' length, then a decode step for each further token: jitted, or
    with `op_by_op` one primitive at a time.  Returns [(logits, cache
    leaves)] after the prefill and after each step, float32 numpy."""
    from repro.models import decode_step, prefill
    max_len = toks.shape[1]

    def pf(p, t):
        return prefill(p, jcfg, t, max_len)

    def df(p, c, t):
        return decode_step(p, jcfg, c, t)

    if not op_by_op:
        pf, df = jax.jit(pf), jax.jit(df)
    with jax.disable_jit(op_by_op):
        logits, cache = pf(jp, jnp.asarray(toks[:, :prompt]))
        out = [(np.asarray(logits, np.float32),
                _cache_leaves(jax_state_leaves(cache)))]
        for i in range(prompt, max_len):
            logits, cache = df(jp, cache, jnp.asarray(toks[:, i:i + 1]))
            out.append((np.asarray(logits, np.float32),
                        _cache_leaves(jax_state_leaves(cache))))
    return out


def serve_port(tcfg, tp, toks: np.ndarray, prompt: int,
               cache=None) -> list:
    """The port's `serve_reference`: prefill and decode steps, or, given
    `cache`, the decode steps from it (then the list starts with the first
    step's)."""
    from repro_torch import convert
    from repro_torch.models import decode_step, prefill
    out = []
    with torch.no_grad():
        if cache is None:
            logits, cache = prefill(tp, tcfg, torch.from_numpy(
                toks[:, :prompt]), toks.shape[1])
            out.append((n(logits.float()), convert.lm_cache_to_numpy(cache)))
        for i in range(prompt, toks.shape[1]):
            logits, cache = decode_step(tp, tcfg, cache, torch.from_numpy(
                toks[:, i:i + 1]))
            out.append((n(logits.float()), convert.lm_cache_to_numpy(cache)))
    return out


def held_serving(got: list, want: list, tol: float) -> dict:
    """Each entry's logits and every cache leaf of `got` against `want`'s,
    relative to the reference tensor's largest entry; the same leaves and
    `pos`.  Returns the largest error by leaf."""
    worst: dict = {}
    assert len(got) == len(want)
    for i, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        assert tl.shape == jl.shape and sorted(tc) == sorted(jc)
        assert int(tc["pos"]) == int(jc["pos"])
        for k, (a, b) in {"logits": (tl, jl),
                          **{k: (tc[k], jc[k]) for k in jc
                             if k != "pos"}}.items():
            a, b = a.astype(np.float64), b.astype(np.float64)
            err = float(np.max(np.abs(a - b))) / max(
                float(np.max(np.abs(b))), 1e-30)
            assert err <= tol, f"entry {i}, {k}: {err:.3g} > {tol}"
            worst[k] = max(worst.get(k, 0.0), err)
    return worst
