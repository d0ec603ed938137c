"""The fused EI kernel's launch plan (`kernels/acq.launch_plan`) and its
summation, and the route of L X = I by size (`kernels/trsv.inverse_entry`).

The kernel runs only on the card (`chip_smoke.py`).  Here the plan is
walked as `csrc/acq.cu` walks it: CTA x of the grid takes column block
x % col_blocks and k-slice x // col_blocks of row block y of study z.  The
kernel's sum is emulated in plain torch on the plan's tiles: each column
block's U summed over its k-slices in slice order, its row sums (q = sum U
K, S1 / S2 = sum a1 / a2, gamma and V1 / V2 = a1 / a2 x_buf, with w = cdf
a1 - 2 dvar a2) over its columns, summed across column blocks in the
kernel's tree order, then combined into EI and its gradient, and held to
the JAX package's `ei_grad_jnp`.
"""
import functools
import math

import numpy as np
import pytest
import torch
from _torch_port import j, n, seeded_states, t
from test_torch_mixed import MIXED, _descs

from repro.core import gp as jgp
from repro.core.kernels import make_mixed_kernel as jmake_mixed_kernel
from repro.kernels import acq as jacq
from repro_torch.kernels import _build, acq, ref, trsv

EI_TOL = dict(rtol=1e-4, atol=1e-5)           # tests/test_fused_acq.py:65
MAX_SHARED = 232448                           # opt-in shared memory of a CTA

PLANS = [(r, nn, b) for r in (1, 7, 64) for nn in (1, 100, 1000, 1024, 40000)
         for b in (1, 3)]


def _walk(plan, n_rows, n_cols):
    """(study, row range, column range, k-tile range) of every CTA, in grid
    order, as the kernel decodes its block index."""
    cols, rows, tps = plan.cols, plan.rows, plan.tiles_per_slice
    col_blocks = -(-n_cols // cols)
    k_tiles = -(-n_cols // acq.TK)
    gx, gy, gz = plan.grid
    assert gx == col_blocks * plan.slices
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                cb, ks = x % col_blocks, x // col_blocks
                yield (z, (y * rows, min(n_rows, y * rows + rows)),
                       (cb * cols, min(n_cols, cb * cols + cols)),
                       (ks * tps, min(k_tiles, ks * tps + tps)))


@pytest.mark.parametrize("r,nn,batch", PLANS)
def test_plan_covers_every_entry_of_u_once(r, nn, batch):
    """Every (row, column) of U of every study is owned by exactly one CTA
    per k-slice, every k-tile by exactly one slice of each (row, column)
    block, no slice is empty, and the scratch holds the row sums of every
    column block and, when k is split, every CTA's partial U tile."""
    plan = acq.launch_plan(batch, r, nn, 5, False)
    owned = np.zeros((plan.slices, batch, r, nn), np.int32)
    tiles = {}
    for z, (r0, r1), (c0, c1), (k0, k1) in _walk(plan, r, nn):
        assert k0 < k1 and r0 < r1 and c0 < c1
        owned[k0 // plan.tiles_per_slice, z, r0:r1, c0:c1] += 1
        tiles.setdefault((z, r0, c0), []).append((k0, k1))
    assert (owned == 1).all()
    k_tiles = -(-nn // acq.TK)
    for ranges in tiles.values():
        assert sorted(ranges)[0][0] == 0 and sorted(ranges)[-1][1] == k_tiles
        assert sum(k1 - k0 for k0, k1 in ranges) == k_tiles
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    blocks = ctas // plan.slices
    split = plan.slices > 1
    assert plan.partial_floats == blocks * plan.rows * (2 * 5 + 4)
    assert plan.u_floats == split * ctas * plan.rows * plan.cols
    assert plan.counters == plan.grid[1] * batch + split * blocks


@pytest.mark.parametrize("d", [1, 5, 6, 20])
@pytest.mark.parametrize("mixed", [False, True])
def test_shared_bytes_do_not_grow_with_n(d, mixed):
    sizes = {acq.launch_plan(1, 64, nn, d, mixed).shared_bytes
             for nn in (1, 100, 1024, 40000, 10**6)}
    assert len(sizes) == 1
    (size,) = sizes
    assert 0 < size <= MAX_SHARED and size % 16 == 0
    assert size == acq.shared_bytes(d, mixed)


def test_main_path_plan_fills_the_card():
    """r = 64 restarts against n_max = 1024: 8 x 64 tiles, k in 4 slices of
    8 tiles, 512 CTAs (about four an SM on 132 SMs)."""
    plan = acq.launch_plan(1, 64, 1024, 5, False)
    assert (plan.rows, plan.cols, plan.slices, plan.tiles_per_slice) == (8, 64, 4, 8)
    assert plan.grid == (64, 8, 1)
    assert acq.launch_plan(1, 64, 1024, 6, True).grid == (64, 8, 1)


def test_large_n_and_batches_need_no_k_split():
    """Large n needs no k-split; a batch keeps the one-study split (4 slices
    at r = 64, n = 1024) and lays its studies along the grid's z axis."""
    assert acq.launch_plan(1, 64, 4096, 5, False).slices == 1
    plan = acq.launch_plan(3, 64, 1024, 5, False)
    assert (plan.slices, plan.tiles_per_slice) == (4, 8)
    assert plan.grid == (64, 8, 3)
    assert acq.launch_plan(1, 1, 1, 1, False).grid == (1, 1, 1)


# The engine's shape (48 restarts, n_max 1024) and r = 64 at three n.
@pytest.mark.parametrize("r,nn", [(48, 1024), (64, 1024), (64, 300),
                                  (64, 4096)])
@pytest.mark.parametrize("mixed", [False, True])
def test_k_split_is_independent_of_the_batch(r, nn, mixed):
    """A lane of an S-study launch sums in the one-study launch's order:
    the same slices and k-tiles a slice for every batch, the grid's x and
    y those of one study and z the batch, the scratch S times one study's.
    At the engine's shape that is 6 slices of 6 tiles, 9216 CTAs at
    S = 16."""
    d = 6 if mixed else 5
    one = acq.launch_plan(1, r, nn, d, mixed)
    for batch in range(1, 65):
        plan = acq.launch_plan(batch, r, nn, d, mixed)
        assert (plan.slices, plan.tiles_per_slice) == (one.slices,
                                                       one.tiles_per_slice)
        assert plan.grid == (*one.grid[:2], batch)
        assert plan.partial_floats == batch * one.partial_floats
        assert plan.u_floats == batch * one.u_floats
        assert plan.counters == batch * one.counters
    if (r, nn) == (48, 1024):
        plan = acq.launch_plan(16, r, nn, d, mixed)
        assert (plan.slices, plan.tiles_per_slice) == (6, 6)
        assert math.prod(plan.grid) == 9216


# The engine's shape split 2 and 4 ways at S = 16 and 1; R = 8 halves;
# r = 64 in 4 at three n.
@pytest.mark.parametrize("r_full,k,nn,batch", [
    (48, 2, 1024, 16), (48, 4, 1024, 16), (48, 2, 1024, 1), (48, 4, 1024, 1),
    (8, 2, 16, 8), (64, 4, 300, 3), (64, 4, 4096, 1), (64, 4, 100, 1)])
@pytest.mark.parametrize("mixed", [False, True])
def test_restart_shard_keeps_the_unsharded_split(r_full, k, nn, batch,
                                                 mixed):
    """A restart shard's launch of R / k rows with `plan_rows=R`: the
    unsharded k-split (slices, tiles a slice, the grid's x), its own row
    blocks and scratch, and every one of its rows walks the same (column
    block, k-tiles) as that row in the unsharded launch."""
    d = 6 if mixed else 5
    r_loc = r_full // k
    full = acq.launch_plan(batch, r_full, nn, d, mixed)
    loc = acq.launch_plan(batch, r_loc, nn, d, mixed, plan_rows=r_full)
    assert (loc.slices, loc.tiles_per_slice) == (full.slices,
                                                 full.tiles_per_slice)
    assert loc.grid == (full.grid[0], -(-r_loc // acq.ROWS), batch)
    blocks = math.prod(loc.grid) // loc.slices
    split = loc.slices > 1
    assert loc.partial_floats == blocks * acq.ROWS * (2 * d + 4)
    assert loc.u_floats == split * math.prod(loc.grid) * acq.TILE_OUTPUTS
    assert loc.counters == loc.grid[1] * batch + split * blocks
    assert acq.launch_plan(batch, r_full, nn, d, mixed,
                           plan_rows=r_full) == full

    def tiles(plan, n_rows, row0=0):
        out = {}
        for z, (r0, r1), cols, ks in _walk(plan, n_rows, nn):
            for i in range(r0, r1):
                out.setdefault((z, row0 + i), []).append((cols, ks))
        return out

    want = tiles(full, r_full)
    for j in range(k):
        got = tiles(loc, r_loc, j * r_loc)
        assert got == {key: want[key] for key in got}
        assert len(got) == batch * r_loc


@pytest.mark.parametrize("args", [(0, 64, 1024, 5, False), (1, 0, 1024, 5, False),
                                  (1, 64, 0, 5, False), (65536, 64, 1024, 5, False),
                                  (1, 8 * 65535 + 1, 1024, 5, False),
                                  (1, 64, 1024, 5000, False)])
def test_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        acq.launch_plan(*args)
    with pytest.raises(ValueError, match="plan_rows"):
        acq.launch_plan(1, 64, 1024, 5, False, plan_rows=32)


@pytest.mark.parametrize("size,entry", [(trsv.MAX_N, "tri_inverse"),
                                        (trsv.MAX_N + 1, "trsv"), (1, "tri_inverse"),
                                        (40000, "trsv")])
def test_inverse_entry_by_size(size, entry):
    """L X = I takes its own kernel up to MAX_N (a panel of X in shared
    memory) and the general solve at B = I beyond it."""
    assert trsv.inverse_entry(size) == entry


# ---------------------------------------------------------------------------
# The kernel's summation, emulated on the plan's tiles
# ---------------------------------------------------------------------------
def _tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis in `tree_sum`'s order (csrc/acq.cu): runs of
    4 in sequence, then a balanced binary tree over the runs."""
    stack = []
    for blk in range(-(-v.shape[0] // 4)):
        s = v[blk * 4]
        for e in range(blk * 4 + 1, min(v.shape[0], blk * 4 + 4)):
            s = s + v[e]
        c = blk
        while c & 1:
            s = stack.pop() + s
            c >>= 1
        stack.append(s)
    s = stack.pop()
    while stack:
        s = stack.pop() + s
    return s


def _tiled_ei_grad(x, x_buf, amask, alpha, a_buf, sigma2, rho, shift, plan,
                   xk=None, xbk=None):
    """`acq.ei_grad_torch` (one study) computed as the kernel splits it."""
    r, d = x.shape
    nn = x_buf.shape[0]
    z_all = torch.sqrt(torch.clamp(
        (x * x).sum(-1)[:, None] + (x_buf * x_buf).sum(-1)[None, :]
        - 2.0 * x @ x_buf.T, min=0.0) + 1e-36) * (5.0 ** 0.5) / rho
    ez = torch.exp(-z_all)
    k = sigma2 * (1.0 + z_all + z_all * z_all / 3.0) * ez
    cat = 1.0
    if xk is not None:
        sqk = torch.clamp((xk * xk).sum(-1)[:, None] + (xbk * xbk).sum(-1)[None, :]
                          - 2.0 * xk @ xbk.T, min=0.0)
        cat = torch.exp(-0.5 * sqk / rho)
        k = k * cat
    km = k * amask
    s_am = (-sigma2 * (5.0 / (3.0 * rho * rho))) * (1.0 + z_all) * ez * cat * amask
    us = {}
    for _, (r0, r1), (c0, c1), (k0, k1) in _walk(plan, r, nn):
        ks = slice(k0 * acq.TK, min(nn, k1 * acq.TK))
        u = km[r0:r1, ks] @ a_buf[ks, c0:c1]              # this slice's U
        prev = us.get((r0, c0))                           # slices in order
        us[(r0, c0)] = u if prev is None else prev + u
    parts = {}
    for (r0, c0), u in us.items():
        rs, cs = slice(r0, r0 + u.shape[0]), slice(c0, c0 + u.shape[1])
        a2 = u * s_am[rs, cs]
        a1 = (alpha * amask)[cs] * s_am[rs, cs]
        g = km[rs, cs] @ alpha[cs]
        part = torch.cat([(u * km[rs, cs]).sum(-1, keepdim=True),
                          a1.sum(-1, keepdim=True), a2.sum(-1, keepdim=True),
                          g[:, None], a1 @ x_buf[cs], a2 @ x_buf[cs]], dim=-1)
        parts.setdefault(r0, []).append(part)
    tot = torch.cat([_tree_sum(torch.stack(parts[r0])) for r0 in sorted(parts)])
    raw_var = sigma2 - tot[:, 0]
    sig = torch.sqrt(torch.clamp(raw_var, min=acq.VAR_FLOOR))
    gam = tot[:, 3] + shift
    zs = gam / torch.clamp(sig, min=1e-12)
    cdf = 0.5 * torch.erfc(-zs / 2.0 ** 0.5)
    pdf = torch.exp(-0.5 * zs * zs) / (2.0 * np.pi) ** 0.5
    ei = torch.clamp(gam * cdf + sig * pdf, min=0.0)
    dvar = torch.where(raw_var > acq.VAR_FLOOR, pdf / (2.0 * sig),
                       torch.zeros_like(sig))
    rowsum = cdf * tot[:, 1] - 2.0 * dvar * tot[:, 2]
    v = cdf[:, None] * tot[:, 4:4 + d] - 2.0 * dvar[:, None] * tot[:, 4 + d:]
    return ei, rowsum[:, None] * x - v


def _float_inputs(n_max, r, seed=11):
    """A seeded GP state with 150 points at `n_max`, and r candidates."""
    rng = np.random.default_rng(seed)
    jst, _ = seeded_states(rng, 150, 4, n_max)
    amask = (np.arange(n_max) < 150).astype(np.float32)
    a_buf = (n(jst.li_buf).T @ n(jst.li_buf)).astype(np.float32)
    y = n(jst.y_buf)[:150]
    shift = float(np.float32(y.mean() - y.max() - 0.01))
    x = rng.uniform(size=(r, 4)).astype(np.float32)
    return (x, n(jst.x_buf), amask, n(jst.alpha), a_buf,
            float(n(jst.params.sigma2)), float(n(jst.params.rho)), shift)


@pytest.fixture(scope="module")
def float_inputs():
    """n_max = 300: five column blocks and k in two slices of 5 tiles."""
    return _float_inputs(300, 13)


def _emulated(args, plan, masks=None):
    x, xb, am, al, ab = (t(a) for a in args[:5])
    if masks is None:
        return _tiled_ei_grad(x, xb, am, al, ab, *args[5:], plan)
    xc, xbc, xk, xbk = acq.split_rows(x, xb, *masks)
    return _tiled_ei_grad(xc, xbc, am, al, ab, *args[5:], plan, xk=xk, xbk=xbk)


# (n_max, r): one k-slice; two; two with eight row blocks; four slices.
@pytest.mark.parametrize("n_max,r", [(200, 13), (300, 13), (300, 64), (600, 5)])
def test_tiled_sum_matches_reference(n_max, r):
    args = _float_inputs(n_max, r)
    x, xb, am, al, ab, s2, rho, shift = args
    plan = acq.launch_plan(1, r, n_max, x.shape[1], False)
    ei, g = _emulated(args, plan)
    ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho, shift)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)


def test_tiled_sum_keeps_the_variance_clamp(float_inputs):
    """Candidates on training points with tiny noise: the clamp binds and
    the dvar term drops out, as in the reference."""
    x, xb, am, al, ab, s2, rho, shift = float_inputs
    x = x.copy()
    x[:3] = xb[:3]
    args = (x, xb, am, al, ab, s2, rho, shift)
    plan = acq.launch_plan(1, 13, 300, 4, False)
    ei, g = _emulated(args, plan)
    ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho, shift)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)


@pytest.mark.parametrize("z", [-6.0, -8.0, -12.0])
def test_tiled_sum_keeps_the_lower_tail(float_inputs, z):
    """Row 0 moved to Z = z (tests/test_torch_kernels.py's construction):
    the split sum keeps EI and its gradient alive, within 2e-3 of a float64
    evaluation, and agrees with the reference at its tolerance."""
    x, xb, am, al, ab, s2, rho, shift = float_inputs
    wide = [torch.from_numpy(a.copy()).double() for a in (x, xb, am, al, ab)]
    km = ref.matern52_gram(wide[0], wide[1], s2, rho) * wide[2]
    gam = km @ wide[3] + shift
    sig = torch.sqrt(s2 - torch.sum((km @ wide[4]) * km, dim=-1))
    shift = float(shift - gam[0] + z * sig[0])        # row 0 sits at Z = z
    args = (x, xb, am, al, ab, s2, rho, shift)
    plan = acq.launch_plan(1, 13, 300, 4, False)
    ei, g = _emulated(args, plan)
    ei_d, g_d = acq.ei_grad_torch(*wide, s2, rho, shift)
    assert float(ei[0]) > 0.0 and np.all(n(g[0]) != 0.0)
    np.testing.assert_allclose(n(ei[0]), n(ei_d[0]), rtol=2e-3)
    np.testing.assert_allclose(n(g[0]), n(g_d[0]), rtol=2e-3)
    ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho, shift)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)


@functools.lru_cache(maxsize=None)
def _mixed_inputs(n_max):
    """A mixed-kernel GP state on `MIXED` (tests/test_torch_mixed.py) with
    150 points at `n_max`, built by the reference, and 13 candidates.
    Noise 1e-2: the demo space's few continuous coordinates put many points
    close together, and at the default 1e-6 the plain version itself misses
    EI_TOL against the reference on such a state (as it does here with 64
    candidates)."""
    rng = np.random.default_rng(12)
    desc, jd = _descs()
    jk = jmake_mixed_kernel(jd.cont_mask, jd.cat_mask)
    xs = MIXED.sample(rng, 150)
    ys = (np.sin(3.0 * xs.sum(-1)) + 0.1 * xs[:, 0]).astype(np.float32)
    cfg = jgp.GPConfig(n_max=n_max, dim=MIXED.dim, implementation="xla",
                       desc=jd, noise2=1e-2)
    st = jgp.refactor(jgp.append_batch(jgp.init_state(cfg), jk, j(xs), j(ys),
                                       implementation="xla"),
                      jk, implementation="xla")
    amask = (np.arange(n_max) < 150).astype(np.float32)
    a_buf = (n(st.li_buf).T @ n(st.li_buf)).astype(np.float32)
    x = MIXED.sample(rng, 13)
    return ((x, n(st.x_buf), amask, n(st.alpha), a_buf,
             float(n(st.params.sigma2)), float(n(st.params.rho)), -0.3),
            desc, jd)


# n_max: one k-slice, two, four.
@pytest.mark.parametrize("n_max", [200, 300, 600])
def test_tiled_sum_matches_reference_mixed(n_max):
    """The mixed form: K and s carry cat, the gradient takes the continuous
    block (exactly 0 on the categorical coordinates)."""
    args, desc, jd = _mixed_inputs(n_max)
    x, xb, am, al, ab, s2, rho, shift = args
    plan = acq.launch_plan(1, 13, n_max, x.shape[1], True)
    ei, g = _emulated(args, plan, (desc.cont_mask, desc.cat_mask))
    ei_w, g_w = jacq.ei_grad_jnp(j(x), j(xb), j(am), j(al), j(ab), s2, rho,
                                 shift, cont_mask=jd.cont_mask,
                                 cat_mask=jd.cat_mask)
    np.testing.assert_allclose(n(ei), n(ei_w), **EI_TOL)
    np.testing.assert_allclose(n(g), n(g_w), **EI_TOL)
    assert np.all(n(g)[:, n(desc.cat_mask) > 0] == 0.0)


# ---------------------------------------------------------------------------
# Dispatch by device
# ---------------------------------------------------------------------------
def test_cpu_tensor_goes_to_the_plain_version(float_inputs, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "load", no_build)
    x, xb, am, al, ab, s2, rho, shift = float_inputs
    before = acq.LAUNCHES
    got = acq.fused_ei_grad(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift)
    want = acq.ei_grad_torch(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift)
    assert acq.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_wrapper_refuses_a_cpu_tensor(float_inputs):
    x, xb, am, al, ab, s2, rho, shift = float_inputs
    before = acq.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        acq.fused_ei_grad_cuda(t(x), t(xb), t(am), t(al), t(ab), s2, rho, shift)
    assert acq.LAUNCHES == before
