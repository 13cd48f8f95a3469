"""The grid-argmin kernel's design, on the CPU.

The CUDA kernel (``src/repro_torch/kernels/grid_argmin/csrc/grid_argmin.cu``)
runs only on the card, where ``chip_smoke.py`` phase 3 holds it against
the plain version.  Here:

(a) a plain-torch model of the kernel's arithmetic — per-rail term tables
    with the leading one-rail run of terms folded into a prefix table, a
    point's delay/dyn/stat combined from them in term order, the objective
    Σdyn·f + Σstat, feasibility as ``min masked delay <= threshold``, and the
    table windows of each cluster rank merged by the first-index rule —
    agrees with the port's ``grid_argmin_ref`` and JAX's
    ``grid_argmin(impl="ref")`` on the default and core-only grids at 25 mV
    and 5 mV steps, a roofline (``delay_mode`` max) platform, a row with
    nothing feasible, and power terms reordered so that a term at pw_v0
    follows the core terms: ``feasible`` equal, power within 1e-5, voltages
    different only at a near-tie within 1e-6.  The model's per-point delay,
    dyn and stat equal, bit for bit, a flat fold of the same term values in
    index order;
(b) the kernel's launch and index arithmetic, written out with numpy from
    the constants read out of its source, with a model of its host-side
    ``make_plan``: every grid point
    of every window is visited once per (platform, row), its table indices
    lie inside the window's tables, each chunk's level sort is a
    permutation that writes every level once, and two blocks' shared
    memory fits an H100 SM's 228 KB; the warp
    reduce-scatter leaves level l's minimum in lane l;
(c) the op's checks (``ops._check_kernel_layout``) take 5551- and
    135,751-point grids and raise for what the kernel cannot take;
(d) ``compare_all_batched`` at ``v_step=0.005`` on the port's CPU path
    matches the JAX package.
"""

import dataclasses
import pathlib
import re
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import characterization as jchar
from repro.core import controller as jctl
from repro.core import voltage as jvolt
from repro.core.accelerators import ACCELERATORS as JACC
from repro.kernels.grid_argmin import grid_argmin as j_grid_argmin
from repro_torch import convert
from repro_torch.core import characterization as tchar
from repro_torch.core import controller as tctl
from repro_torch.core import voltage as tvolt
from repro_torch.core import workload as twl
from repro_torch.core.accelerators import ACCELERATORS as TACC
from repro_torch.kernels.grid_argmin import grid_argmin, grid_argmin_ref, ops

POWER_TOL = 1e-5
NEAR_TIE = 1e-6
SUMMARY_RTOL = 1e-5
SMEM_PER_SM = 228 * 1024      # an H100 SM's shared memory; each block reserves 1 KB
SOURCE = (pathlib.Path(ops.__file__).parent / "csrc" / "grid_argmin.cu").read_text()
RAIL_CORE, RAIL_BRAM, RAIL_FIXED = tchar.RAIL_CORE, tchar.RAIL_BRAM, tchar.RAIL_FIXED


def _constant(name):
    """A design constant (``constexpr int name = value;``) of the kernel's source."""
    match = re.search(rf"^constexpr int {name} = (\d+);", SOURCE, re.M)
    assert match, f"{name} not found in grid_argmin.cu"
    return int(match.group(1))


(THREADS, BATCH, SLOTS, MAX_LEVELS, MAX_SPLIT, BLOCKS_PER_SM, MIN_RANK_POINTS,
 SMEM_BUDGET, STAGED_GRID) = (
    _constant(k) for k in ("kThreads", "kBatch", "kSlots", "kMaxLevels", "kMaxSplit",
                           "kBlocksPerSm", "kMinRankPoints", "kSmemBudget", "kStagedGrid"))
H100_SMS = 132
WARPS = THREADS // 32
# The kernel's static shared memory: thresholds, levels and their order
# [slots] each, the warps' (value, index) minima [warps][32], their delay
# minima, the block's result [32] and delay minimum.
STATIC_SMEM = 4 * (3 * SLOTS + 2 * WARPS * 32 + WARPS + 2 * 32 + 1)


# ---------------------------------------------------------------- the launch plan


class Plan(NamedTuple):
    """One launch's shape: a cluster of ``split`` blocks per (platform,
    row), each over ``range`` flat points in table windows of ``window``
    points, with ``width`` entries a table row."""

    split: int
    range: int
    window: int
    width: int


def _align16(n):
    return (n + 15) // 16 * 16


def smem_bytes(d, t, c, b, width, window):
    """The ``.cu``'s ``smem_layout``: tables of at most D + 2T rows, the
    platform's terms (5D + 7T words), unit descriptors, both grids where
    C + B <= kStagedGrid, the window's mask bytes."""
    grids = _align16((c + b) * 4) if c + b <= STAGED_GRID else 0
    return (_align16((d + 2 * t) * width * 4) + _align16((5 * d + 7 * t) * 4)
            + (d + t) * 16 + grids + _align16(window))


def table_width(window, b):
    """Entries a table row needs for any ``window`` consecutive flat points."""
    return max((window + b - 2) // b + 1, min(b, window))


def make_plan(n_p, n_r, c, b, d, t, sms=H100_SMS):
    """The ``.cu``'s ``make_plan``; None where the terms alone exceed the
    shared-memory budget (the launch returns an error)."""
    g = c * b
    split = min(MAX_SPLIT, max(1, BLOCKS_PER_SM * sms // (n_p * n_r)),
                max(1, g // MIN_RANK_POINTS))
    rng = -(-g // split)

    def fits(n):
        return smem_bytes(d, t, c, b, table_width(n, b), n) <= SMEM_BUDGET

    if not fits(1):
        return None
    lo, hi = 1, rng
    while lo < hi:
        mid = lo + (hi - lo + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return Plan(split, rng, lo, table_width(lo, b))


# ---------------------------------------------------------------- inputs


def _fleet(fixed_after_core=False):
    """Five Table I accelerators plus one roofline platform, as numpy leaves;
    with ``fixed_after_core`` each platform's power terms are reordered to
    its core terms, then one term at pw_v0, then the rest."""
    jp = jchar.stack_platform_params(
        [jctl.fpga_platform(JACC[n]).params for n in sorted(JACC)]
        + [jchar.tpu_platform_params(0.002, 0.012, 0.001, "max")])
    leaves = {f: np.asarray(x) for f, x in zip(jp._fields, jp)}
    if fixed_after_core:
        order = []
        for rails in leaves["pw_rail"].tolist():
            core = [i for i, r in enumerate(rails) if r == RAIL_CORE]
            fixed = [i for i, r in enumerate(rails) if r not in (RAIL_CORE, RAIL_BRAM)][:1]
            order.append(core + fixed + [i for i in range(len(rails)) if i not in core + fixed])
        order = np.asarray(order)
        leaves = {f: np.take_along_axis(x, order, 1) if f.startswith("pw_") else x
                  for f, x in leaves.items()}
        jp = type(jp)(**{f: jnp.asarray(x) for f, x in leaves.items()})
    return jp, leaves


def _rows(grids, n_bins=25, margin=0.05):
    """[R, C, B] masks and [R, M] levels: every technique, every hybrid
    gear, and one row that excludes the nominal corner at f = 1."""
    levels = np.asarray(jvolt.bin_frequency_levels(n_bins, margin, 0.10))
    masks = [np.asarray(jvolt.technique_grid_mask(t, grids)) for t in jctl.TECHNIQUES]
    rows = [levels] * len(masks)
    _, f_node, _ = jctl._hybrid_gears(jctl.ControllerConfig(n_bins=n_bins, margin=margin))
    full = np.asarray(jvolt.technique_grid_mask("hybrid", grids))
    masks += [full] * f_node.shape[0]
    rows += list(np.asarray(f_node))
    no_nominal = np.ones_like(full)
    no_nominal[-1, -1] = False
    masks.append(no_nominal)
    rows.append(np.ones(n_bins, np.float32))
    return np.stack(masks), np.stack(rows).astype(np.float32)


def _inputs(grid_name, v_step, fixed_after_core=False):
    jg = getattr(jvolt.VoltageGrids, grid_name)(v_step)
    tg = getattr(tvolt.VoltageGrids, grid_name)(v_step)
    jp, leaves = _fleet(fixed_after_core)
    masks, levels = _rows(jg)
    tp = convert.platform_params_from_numpy(leaves, device="cpu")
    return jp, jg, tp, tg, masks, levels


# ---------------------------------------------------------------- (a) the model


def _one(params, p):
    """Platform ``p``'s leaves."""
    return tchar.PlatformParams(*[x[p] for x in params])


def _delay_rail(code):
    return RAIL_CORE if code == RAIL_CORE else RAIL_BRAM


def _units(pp):
    """The kernel's table units: ``(delay units, power units)``, each a list
    of ``(rail, first term, last term + 1)``; the first unit of each is the
    leading run of terms on one rail, which power terms at pw_v0 may sit
    inside but do not end."""
    drail = [_delay_rail(int(x)) for x in pp.dl_rail]
    npd = 1
    while npd < len(drail) and drail[npd] == drail[0]:
        npd += 1
    delay = [(drail[0], 0, npd)] + [(drail[i], i, i + 1) for i in range(npd, len(drail))]
    prail = [int(x) if int(x) in (RAIL_CORE, RAIL_BRAM) else RAIL_FIXED for x in pp.pw_rail]
    run, end = None, len(prail)      # a run of terms at pw_v0 alone: all of them
    for i, rail in enumerate(prail):
        if rail == RAIL_FIXED:
            continue
        if run is None:
            run = rail
        elif rail != run:
            break
        end = i + 1                     # one past the run's last term on its rail
    npp = end
    power = [(RAIL_FIXED if run is None else run, 0, npp)]
    power += [(prail[i], i, i + 1) for i in range(npp, len(prail))]
    return delay, power


def _delay_terms(pp, v):
    """[D, n]: every delay term at every voltage of ``v`` (the kernel's
    delay_term, den once per term)."""
    den = pp.dl_v0 / (pp.dl_v0 - pp.dl_vth) ** pp.dl_alpha
    num = v[None] / torch.clamp(v[None] - pp.dl_vth[:, None], min=1e-6) ** pp.dl_alpha[:, None]
    return pp.dl_weight[:, None] * (num / den[:, None])


def _power_terms(pp, v):
    """([T, n], [T, n]): every power term's dyn and stat at ``v``, or at its
    pw_v0 for a term on no scalable rail (the kernel's power_term)."""
    on_rail = (pp.pw_rail == RAIL_CORE) | (pp.pw_rail == RAIL_BRAM)
    vi = torch.where(on_rail[:, None], v[None], pp.pw_v0[:, None])
    x = vi / pp.pw_v0[:, None]
    dyn = pp.pw_dyn[:, None] * (x * x)
    stat = pp.pw_stat[:, None] * x * torch.exp(pp.pw_kappa[:, None] * (vi - pp.pw_v0[:, None]))
    return dyn, stat


def _fold(terms, max_mode=False):
    acc = terms[0]
    for t in terms[1:]:
        acc = torch.maximum(acc, t) if max_mode else acc + t
    return acc


def _window_library(pp, core, bram, w0, w1, prefix=True):
    """Per-point (delay, dyn, stat) of flat points [w0, w1) from the window's
    per-rail tables.  ``prefix=False`` folds every term of every point in
    index order instead (the flat evaluation), from the same term values."""
    b = len(bram)
    g = torch.arange(w0, w1)
    ci, bi = g // b, g % b
    c_lo, b_lo = w0 // b, w0 % b
    nc, nb = (w1 - 1) // b - c_lo + 1, min(b, w1 - w0)
    vc = core[c_lo:c_lo + nc]
    vb = bram[(b_lo + torch.arange(nb)) % b]
    lc, lb = ci - c_lo, (bi - b_lo) % b
    tables = {RAIL_CORE: (vc, lc), RAIL_BRAM: (vb, lb),
              RAIL_FIXED: (vc[:1], torch.zeros_like(g))}
    max_mode = int(pp.delay_mode) == 1
    d_units, p_units = _units(pp)
    if not prefix:   # one unit a term
        d_units = [(rail, i, i + 1) for rail, a, z in d_units for i in range(a, z)]
        p_units = [(rail, i, i + 1) for rail, a, z in p_units for i in range(a, z)]
    delays, dyns, stats = [], [], []
    for rail, a, z in d_units:
        v, idx = tables[rail]
        row = _fold(list(_delay_terms(pp, v)[a:z]), max_mode)
        delays.append(row[idx])
    for rail, a, z in p_units:
        v, idx = tables[rail]
        dyn, stat = _power_terms(pp, v)
        dyns.append(_fold(list(dyn[a:z]))[idx])
        stats.append(_fold(list(stat[a:z]))[idx])
    return _fold(delays, max_mode), _fold(dyns), _fold(stats)


def _windows(launch, g):
    """(w0, w1) of every rank's table windows, rank by rank, ascending."""
    for rank in range(launch.split):
        lo = min(g, rank * launch.range)
        hi = min(g, lo + launch.range)
        for w0 in range(lo, hi, launch.window):
            yield w0, min(hi, w0 + launch.window)


def kernel_model(params, masks, levels, core, bram, launch, slack_eps=1e-6):
    """The kernel's arithmetic in plain torch: ``[P, R, M]`` fields."""
    n_p, (n_r, n_m), b = params.watts_scale.shape[0], levels.shape, len(bram)
    g = len(core) * b
    thr = 1.0 / torch.clamp(levels, min=1e-6) * torch.tensor(1.0 + slack_eps)
    flat = masks.reshape(n_r, g)
    out = {k: torch.empty(n_p, n_r, n_m) for k in ("v_core", "v_bram", "power")}
    feasible = torch.empty(n_p, n_r, n_m, dtype=torch.bool)
    for p in range(n_p):
        pp = _one(params, p)
        best_v = torch.full((n_r, n_m), torch.inf)
        best_i = torch.zeros((n_r, n_m), dtype=torch.long)
        dmin = torch.full((n_r,), torch.inf)
        for w0, w1 in _windows(launch, g):
            delay, dyn, stat = _window_library(pp, core, bram, w0, w1)
            msk = flat[:, w0:w1]                                          # [R, n]
            dmin = torch.minimum(dmin, torch.where(msk, delay, torch.inf).amin(-1))
            obj = dyn * levels[..., None] + stat                          # [R, M, n]
            ok = (delay <= thr[..., None]) & msk[:, None]
            masked = torch.where(ok, obj, torch.inf)
            v, i = masked.min(-1)                                         # first index
            i = torch.where(torch.isinf(v), 0, i + w0)    # the kernel keeps (inf, 0)
            take = (v < best_v) | ((v == best_v) & (i < best_i))
            best_v, best_i = torch.where(take, v, best_v), torch.where(take, i, best_i)
        any_f = dmin[:, None] <= thr
        nom = _power_terms(pp, torch.stack([core[-1], bram[-1]]))
        on_core = (pp.pw_rail == RAIL_CORE)
        nom_dyn = _fold(list(torch.where(on_core, nom[0][:, 0], nom[0][:, 1])))
        nom_stat = _fold(list(torch.where(on_core, nom[1][:, 0], nom[1][:, 1])))
        idx = torch.where(any_f, best_i, g - 1)
        out["power"][p] = torch.where(any_f, best_v, nom_dyn * levels + nom_stat)
        out["v_core"][p], out["v_bram"][p] = core[idx // b], bram[idx % b]
        feasible[p] = any_f
    return tvolt.OperatingPoint(v_core=out["v_core"], v_bram=out["v_bram"],
                                f_rel=levels[None].expand(n_p, n_r, n_m),
                                power=out["power"], feasible=feasible)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch's CPU exp can take another code path on a fresh worker thread
    (ROADMAP C); one thread keeps the bitwise comparisons deterministic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_matches(name, out, ref, params):
    """feasible equal, power within 1e-5, voltages equal except at a near-tie."""
    ref = [np.asarray(getattr(ref, f)) for f in ("v_core", "v_bram", "power", "feasible")]
    v_core, v_bram, power, feas = (getattr(out, f).numpy()
                                   for f in ("v_core", "v_bram", "power", "feasible"))
    np.testing.assert_array_equal(feas, ref[3], err_msg=name)
    np.testing.assert_allclose(power, ref[2], rtol=POWER_TOL, atol=POWER_TOL, err_msg=name)
    differs = (v_core != ref[0]) | (v_bram != ref[1])
    per_cell = tchar.PlatformParams(*[x.reshape(x.shape[:1] + (1, 1) + x.shape[1:])
                                      for x in params])
    at_out = tchar.params_power(per_cell, out.v_core, out.v_bram, out.f_rel).numpy()
    tie = np.abs(at_out - ref[2]) <= NEAR_TIE * np.abs(ref[2])
    assert not (differs & ~tie).any(), f"{name}: voltages differ off a near-tie"


def _plan(name, tp, masks, tg):
    """The kernel's plan, or (``split3_window97``) one with more ranks and
    windows than the kernel takes at these sizes, to exercise the merges."""
    c, b = len(tg.core), len(tg.bram)
    if name == "split3_window97":
        g = c * b
        return Plan(3, -(-g // 3), 97, table_width(97, b))
    return make_plan(tp.watts_scale.shape[0], masks.shape[0], c, b,
                     tp.dl_weight.shape[-1], tp.pw_dyn.shape[-1])


@pytest.mark.parametrize("plan_name", ["default", "split3_window97"])
@pytest.mark.parametrize("v_step", [0.025, 0.005])
@pytest.mark.parametrize("grid_name", ["default", "core_only"])
def test_model_of_kernel_matches_refs(grid_name, v_step, plan_name):
    jp, jg, tp, tg, masks, levels = _inputs(grid_name, v_step)
    tm, tl = torch.from_numpy(masks), torch.from_numpy(levels)
    launch = _plan(plan_name, tp, tm, tg)
    out = kernel_model(tp, tm, tl, tg.core, tg.bram, launch)
    ref_t = grid_argmin_ref(tp, tm, tl, tg.core, tg.bram)
    ref_j = j_grid_argmin(jp, jnp.asarray(masks), jnp.asarray(levels), jg.core,
                          jg.bram, impl="ref")
    _assert_matches("vs port plain", out, ref_t, tp)
    _assert_matches("vs jax ref", out, ref_j, tp)
    # the roofline platform is in the fleet; the last row finds nothing
    # feasible on the FPGA platforms and falls back to the nominal corner
    assert int(tp.delay_mode[-1]) == 1
    assert not out.feasible[:len(JACC), -1].any()
    assert (out.v_core[:len(JACC), -1] == tg.core[-1]).all()


@pytest.mark.parametrize("plan_name", ["default", "split3_window97"])
def test_model_matches_refs_with_a_term_at_v0_after_the_core_run(plan_name):
    """A term at pw_v0 right after the core power terms: the leading run ends
    at the last core term and the term at pw_v0 is a unit of its own."""
    jp, jg, tp, tg, masks, levels = _inputs("default", 0.005, fixed_after_core=True)
    assert _units(_one(tp, 0))[1][:3] == [(RAIL_CORE, 0, 3), (RAIL_FIXED, 3, 4),
                                          (RAIL_BRAM, 4, 5)]
    tm, tl = torch.from_numpy(masks), torch.from_numpy(levels)
    out = kernel_model(tp, tm, tl, tg.core, tg.bram, _plan(plan_name, tp, tm, tg))
    _assert_matches("vs port plain", out, grid_argmin_ref(tp, tm, tl, tg.core, tg.bram), tp)
    ref_j = j_grid_argmin(jp, jnp.asarray(masks), jnp.asarray(levels), jg.core,
                          jg.bram, impl="ref")
    _assert_matches("vs jax ref", out, ref_j, tp)


@pytest.mark.parametrize("fixed_after_core", [False, True])
@pytest.mark.parametrize("window", [40, 97, 460, 5551])
def test_model_library_is_the_flat_fold_bit_for_bit(window, fixed_after_core):
    _, _, tp, tg, _, _ = _inputs("default", 0.005, fixed_after_core)
    g = len(tg.core) * len(tg.bram)
    for p in range(tp.watts_scale.shape[0]):
        pp = _one(tp, p)
        for w0 in range(0, g, window):
            w1 = min(g, w0 + window)
            model = _window_library(pp, tg.core, tg.bram, w0, w1)
            flat = _window_library(pp, tg.core, tg.bram, w0, w1, prefix=False)
            for a, b in zip(model, flat):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            if window == 5551:   # and the plain version's delay, to rounding
                vc = tg.core[torch.arange(w0, w1) // len(tg.bram)]
                vb = tg.bram[torch.arange(w0, w1) % len(tg.bram)]
                torch.testing.assert_close(model[0], tchar.params_delay(pp, vc, vb),
                                           rtol=1e-6, atol=0)


@pytest.mark.parametrize("fixed_after_core", [False, True])
def test_units_fold_each_term_once_in_order(fixed_after_core):
    _, _, tp, _, _, _ = _inputs("default", 0.025, fixed_after_core)
    for p in range(tp.watts_scale.shape[0]):
        pp = _one(tp, p)
        rails = ([_delay_rail(int(x)) for x in pp.dl_rail],
                 [int(x) if int(x) in (RAIL_CORE, RAIL_BRAM) else RAIL_FIXED
                  for x in pp.pw_rail])
        for units, term_rails in zip(_units(pp), rails):
            n = len(term_rails)
            assert [i for _, a, z in units for i in range(a, z)] == list(range(n))
            assert len(units) <= n
            assert term_rails[units[0][2] - 1] == units[0][0]   # the run ends on its rail
    fpga = _units(_one(tp, 0))
    assert fpga[0][0] == (RAIL_CORE, 0, 3) and len(fpga[0]) == 2   # 3 core terms, 1 bram
    # then b, b, 3 at v0 (or: 1 at v0, b, b, 2 at v0)
    assert fpga[1][0] == (RAIL_CORE, 0, 3) and len(fpga[1]) == 6


def _leading_run_ballots(rails):
    """The kernel's ``leading_run``, lane by lane: ``(length, rail)`` from
    32-lane ballots, ``__ffs`` and ``__clz``; rail -1 for a run of terms at
    pw_v0 alone."""
    n, run, end = len(rails), -1, 0

    def ballot(pred):
        return sum(1 << lane for lane in range(32) if pred(lane))

    for c in range(0, n, 32):
        key = [rails[c + lane] if c + lane < n and rails[c + lane] in (RAIL_CORE, RAIL_BRAM)
               else -1 for lane in range(32)]
        if run < 0:
            keyed = ballot(lambda lane: key[lane] >= 0)
            if keyed:
                run = key[(keyed & -keyed).bit_length() - 1]
        valid = ballot(lambda lane: c + lane < n)
        broken = valid & ~ballot(lambda lane: key[lane] < 0 or key[lane] == run)
        before = (1 << ((broken & -broken).bit_length() - 1)) - 1 if broken else 0xFFFFFFFF
        on_run = ballot(lambda lane: key[lane] >= 0 and key[lane] == run) & before
        if on_run:
            end = c + on_run.bit_length()            # c + 32 - __clz(on_run)
        if broken:
            break
    return (n, -1) if run < 0 else (end, run)


def _power_units(rails):
    pp = tchar.PlatformParams(*[torch.tensor(rails) if f == "pw_rail" else
                                torch.tensor([RAIL_CORE]) if f == "dl_rail" else None
                                for f in tchar.PlatformParams._fields])
    return _units(pp)[1]


@pytest.mark.parametrize("rails,want", [
    ([RAIL_CORE, RAIL_FIXED, RAIL_BRAM],
     [(RAIL_CORE, 0, 1), (RAIL_FIXED, 1, 2), (RAIL_BRAM, 2, 3)]),
    ([RAIL_FIXED, RAIL_BRAM, RAIL_FIXED, RAIL_BRAM, RAIL_FIXED],
     [(RAIL_BRAM, 0, 4), (RAIL_FIXED, 4, 5)]),
    ([RAIL_FIXED, RAIL_FIXED], [(RAIL_FIXED, 0, 2)]),
    ([RAIL_BRAM, RAIL_BRAM], [(RAIL_BRAM, 0, 2)]),
])
def test_power_run_ends_at_its_last_term_on_its_rail(rails, want):
    """Any term order: the leading run never ends on a term at pw_v0 unless
    every term of it is at pw_v0 (its fold row then has the one entry)."""
    assert _power_units(rails) == want
    length, rail = _leading_run_ballots(rails)
    assert (RAIL_FIXED if rail < 0 else rail, 0, length) == want[0]


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 64, 70])
def test_leading_run_from_ballots_matches_the_units(n):
    """Random term orders across the kernel's 32-term ballot chunks."""
    rng = np.random.default_rng(n)
    for _ in range(200):
        p_fixed, p_bram = rng.uniform(0, 1, 2)
        rails = [RAIL_FIXED if rng.uniform() < p_fixed else
                 RAIL_BRAM if rng.uniform() < p_bram / 8 else RAIL_CORE for _ in range(n)]
        rail, first, end = _power_units(rails)[0]
        length, run = _leading_run_ballots(rails)
        assert (first, end, rail) == (0, length, RAIL_FIXED if run < 0 else run), rails


# ---------------------------------------------------------------- (b) launch arithmetic


def test_design_constants_fit_the_blocks_an_sm_holds():
    assert MAX_LEVELS <= SLOTS == 32 and MAX_LEVELS % 4 == 0  # a level a lane; groups of 4
    # the blocks an SM the launch bounds ask for fit its shared memory
    assert BLOCKS_PER_SM * (SMEM_BUDGET + STATIC_SMEM + 1024) <= SMEM_PER_SM
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in SOURCE
    assert 1 <= MAX_SPLIT <= 8                                # a portable cluster


GRIDS = [(1, 1), (1, 5), (5, 1), (13, 19), (13, 1), (1, 19), (7, 300), (300, 7),
         (61, 91), (3, 5000), (301, 451)]


@pytest.mark.parametrize("c,b", GRIDS)
def test_every_point_is_visited_once_inside_its_tables(c, b):
    """The kernel's walk: each warp's lanes start at w0 + 32·warp + lane and
    take BATCH points kThreads apart an iteration (one where the warp's
    second point would be past the window), stepping (ci, bi) without a
    division; every point of every window once, with its table indices
    inside the window's tables."""
    g = c * b
    lanes = np.arange(32)
    for n_p, n_r in ((5, 12), (1, 1)):    # Table II's 60 clusters; one, split wider
        launch = make_plan(n_p, n_r, c, b, 4, 8)
        assert 1 <= launch.split <= MAX_SPLIT and launch.split * launch.range >= g
        assert smem_bytes(4, 8, c, b, launch.width, launch.window) <= SMEM_BUDGET
        visits = np.zeros(g, np.int64)
        step_c, step_b = THREADS // b, THREADS % b
        for w0, w1 in _windows(launch, g):
            c_lo, b_lo = w0 // b, w0 - (w0 // b) * b
            nc, nb = (w1 - 1) // b - c_lo + 1, min(b, w1 - w0)
            assert nc <= launch.width and nb <= launch.width and w1 - w0 <= launch.window
            for warp in range(THREADS // 32):
                first = w0 + 32 * warp + lanes
                ci, bi = first // b, first % b
                for g0 in range(w0 + 32 * warp, w1, BATCH * THREADS):
                    batch = BATCH if g0 + (BATCH - 1) * THREADS < w1 else 1
                    for q in range(batch):
                        gq = g0 + lanes + q * THREADS
                        live = gq < w1
                        np.testing.assert_array_equal(ci[live] * b + bi[live], gq[live])
                        lc = ci[live] - c_lo
                        lb = np.where(bi[live] >= b_lo, bi[live] - b_lo, bi[live] - b_lo + b)
                        assert (0 <= lc).all() and (lc < nc).all()
                        assert (0 <= lb).all() and (lb < nb).all()
                        np.testing.assert_array_equal((b_lo + lb) % b, bi[live])
                        visits[gq[live]] += 1
                        bi, ci = bi + step_b, ci + step_c
                        wrap = bi >= b
                        bi, ci = np.where(wrap, bi - b, bi), np.where(wrap, ci + 1, ci)
        assert (visits == 1).all(), (c, b, launch)


def _sorted_slots(thr, valid):
    """The kernel's stage_levels: each lane's slot from 32 shuffles."""
    rank = np.zeros(32, np.int64)
    for lane in range(32):
        for k in range(32):
            if valid[k] != valid[lane]:
                rank[lane] += valid[k]
            else:
                rank[lane] += thr[k] > thr[lane] or (not thr[k] < thr[lane] and k < lane)
    return rank


@pytest.mark.parametrize("m", [1, 4, 25, 28, 29, 64, 100])
def test_levels_are_sorted_and_each_written_once(m):
    rng = np.random.default_rng(m)
    levels = rng.choice([0.1, 0.25, 0.5, 0.5, 0.75, 1.0], m).astype(np.float32)  # ties
    written = []
    for m0 in range(0, m, MAX_LEVELS):
        lanes = np.arange(32)
        valid = (lanes < MAX_LEVELS) & (m0 + lanes < m)
        f = np.where(valid, levels[np.minimum(m0 + lanes, m - 1)], 0.0)
        thr = np.where(valid, np.float32(1.0) / np.maximum(f, 1e-6), np.nan)
        rank = _sorted_slots(thr, valid)
        assert sorted(rank) == list(range(32))                 # a permutation
        perm = np.empty(32, np.int64)
        perm[rank] = lanes
        nvalid = min(MAX_LEVELS, m - m0)
        assert valid[perm[:nvalid]].all() and not valid[perm[nvalid:]].any()
        assert (np.diff(thr[perm[:nvalid]]) <= 0).all()        # largest threshold first
        written += [m0 + int(perm[slot]) for slot in range(nvalid)]
    assert sorted(written) == list(range(m))


def test_warp_reduce_scatter_leaves_level_l_in_lane_l():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 4, (32, 32)).astype(np.float32)     # [lane, slot], with ties
    v[:, 5] = np.inf                                        # a level nothing met
    i = rng.integers(0, 1000, (32, 32))
    i[:, 5] = 0
    want = [min(zip(v[:, s], i[:, s])) for s in range(32)]  # lexicographic
    lanes = np.arange(32)
    for half in (16, 8, 4, 2, 1):
        upper = (lanes & half) != 0
        keep_v = np.where(upper[:, None], v[:, half:2 * half], v[:, :half])
        keep_i = np.where(upper[:, None], i[:, half:2 * half], i[:, :half])
        give_v = np.where(upper[:, None], v[:, :half], v[:, half:2 * half])
        give_i = np.where(upper[:, None], i[:, :half], i[:, half:2 * half])
        got_v, got_i = give_v[lanes ^ half], give_i[lanes ^ half]
        take = (got_v < keep_v) | ((got_v == keep_v) & (got_i < keep_i))
        v[:, :half] = np.where(take, got_v, keep_v)
        i[:, :half] = np.where(take, got_i, keep_i)
    assert [(v[l, 0], i[l, 0]) for l in range(32)] == want


# ---------------------------------------------------------------- (c) the op's checks


def _sweep(v_step):
    grids, _, masks, rows = tctl._sweep_rows(tctl.ControllerConfig(v_step=v_step),
                                             tctl.DEFAULT_TECHNIQUES)
    tp = tchar.stack_platform_params([tctl.fpga_platform(a).params for a in TACC.values()])
    return tp, masks, rows, grids


@pytest.mark.parametrize("v_step,points", [(0.005, 5551), (0.001, 135751)])
def test_layout_check_takes_fine_grids(v_step, points):
    tp, masks, rows, grids = _sweep(v_step)
    assert masks[0].numel() == points
    ops._check_kernel_layout(tp, masks, rows, grids.core, grids.bram)
    launch = make_plan(tp.watts_scale.shape[0], masks.shape[0], len(grids.core),
                       len(grids.bram), tp.dl_weight.shape[-1], tp.pw_dyn.shape[-1])
    assert launch.split * launch.range >= points
    assert smem_bytes(4, 8, len(grids.core), len(grids.bram), launch.width,
                      launch.window) <= SMEM_BUDGET
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_kernel_layout(tp, masks.transpose(1, 2).contiguous().transpose(1, 2),
                                 rows, grids.core, grids.bram)
    with pytest.raises(TypeError, match="levels"):
        grid_argmin(tp, masks, rows.double(), grids.core, grids.bram)
    with pytest.raises(ValueError, match="masks"):
        grid_argmin(tp, masks[:, :-1], rows, grids.core, grids.bram)
    with pytest.raises(ValueError, match="devices"):
        grid_argmin(tp, masks.to("meta"), rows, grids.core, grids.bram)


def test_only_int32_indices_and_the_terms_limit_the_launch():
    assert make_plan(1, 1, 46340, 46340, 4, 8).split == MAX_SPLIT   # 2.1 G points
    tp, _, rows, grids = _sweep(0.025)
    n = ops.MAX_FLAT_POINTS // len(grids.bram) + 1       # one core voltage too many
    with pytest.raises(ValueError, match="int32"):
        ops._check_kernel_layout(
            tp, torch.ones(1, 1, 1, dtype=torch.bool).expand(1, n, len(grids.bram)),
            rows[:1], grids.core[:1].expand(n), grids.bram)
    assert make_plan(1, 1, 13, 19, 4000, 8000) is None   # the launch returns an error


# ---------------------------------------------------------------- (d) the main path


def test_compare_all_batched_at_5mV_matches_jax():
    trace = twl.generate_trace(twl.WorkloadConfig(n_steps=256, seed=1))
    ref = jctl.compare_all_batched([jctl.fpga_platform(JACC["tabla"])], trace,
                                   v_step=0.005)
    out = tctl.compare_all_batched([tctl.fpga_platform(TACC["tabla"])], trace,
                                   device="cpu", v_step=0.005)
    assert list(ref) == list(out)
    for plat in ref:
        for tech, r in ref[plat].items():
            o = out[plat][tech]
            for f in dataclasses.fields(r):
                a, b = getattr(r, f.name), getattr(o, f.name)
                if f.name in ("technique", "misprediction_rate", "margin_misprediction_rate"):
                    assert a == b, (plat, tech, f.name)
                else:
                    np.testing.assert_allclose(b, a, rtol=SUMMARY_RTOL, atol=0,
                                               err_msg=f"{plat}/{tech}: {f.name}")
