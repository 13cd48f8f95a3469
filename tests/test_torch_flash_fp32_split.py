"""The float32 attention kernels' split-TF32 arithmetic, modelled on the CPU.

``csrc/flash_attention.cu`` (forward, head_dim up to its ``kSplitMaxD``) and
``csrc/flash_attention_bwd.cu`` (backward, up to its own ``kSplitMaxD``) run
every float32 product on the tensor cores as split TF32: each operand
x = hi + lo with hi = tf32(x) rounded to nearest (ties away, as
``cvt.rna.tf32.f32``) and lo = tf32(x − hi); each product is three TF32
products, the small terms lo·hi and hi·lo of every 8-deep k step first and
then the hi·hi ones, summed into one fp32 accumulator.  Here ``tf32_rna``
rounds by bit operations on float32, and the kernels' products go through
``split_mm`` in their own blocks (one wgmma instruction's 8-term sum, taken
exactly and rounded once, added to the accumulator in the kernels' order),
with the kernels' tiles, online softmax, per-thread row sums, warpgroup
partial sums and stats read from their sources' constants.

The models are held to the float64 plain function (the exact attention and
its gradients, by autograd in float64) and to the plain float32 versions
that ``chip_smoke.py`` phases 5 and 5b compare the kernels with (``ref.py``
within 2e-5, ``backward.py`` within 1e-4 of each gradient's max |g|).  A
one-pass TF32 model (the same products without the split) misses those
tolerances, so these tests can tell the two apart.  They fix the arithmetic
before a chip run; the card's phases 5 and 5b still decide, since the
tensor cores' own summation inside an instruction is not modelled.
"""

import ast
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"
FWD_SOURCE = (CSRC / "flash_attention.cu").read_text()
BWD_SOURCE = (CSRC / "flash_attention_bwd.cu").read_text()
NEG_INF = -2.0e38
FWD_TOL, BWD_TOL = 2e-5, 1e-4   # chip_smoke.py's FLASH_TOL and FLASH_BWD_TOL in float32
# How much farther from float64 than the plain float32 version the split model may be:
# split TF32 keeps about 2^-22 of each operand (fp32 rounds to 2^-24) and its products
# sum in blocks of 8, so its distance is of the plain version's order, not 2^12 times it
# as one TF32 pass is.
FACTOR = 4.0


def _const(source: str, name: str) -> int:
    match = re.search(rf"^constexpr int {name} = (\d+);", source, re.M)
    assert match, name
    return int(match.group(1))


def _smoke_list(name: str) -> list:
    """A case list of chip_smoke.py, read from its source (not imported: the
    script is the card's)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(name)


FLASH_CASES = _smoke_list("FLASH_CASES")
FLASH_SOFTCAP_CASES = _smoke_list("FLASH_SOFTCAP_CASES")
# llama3.2-1b's shape cut to size: its head_dim, GQA and causal mask at S = 256
LLAMA_REDUCED = (1, 256, 2, 4, 64, True, None, None)


# ---- the arithmetic -----------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 mantissa bits, ties away from zero, by adding half
    a TF32 ulp to the magnitude bits and clearing the low 13."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _blocks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 8-deep k steps of a @ b (a [..., M, K], b [..., K, N]): each step's
    sum taken exactly (float64) and rounded once to fp32, [K/8, ..., M, N]."""
    k = a.shape[-1]
    nb = -(-k // 8)
    if nb * 8 != k:   # the kernels zero-pad head_dim
        a = torch.nn.functional.pad(a, (0, nb * 8 - k))
        b = torch.nn.functional.pad(b, (0, 0, 0, nb * 8 - k))
    a4 = a.double().reshape(*a.shape[:-1], nb, 8)
    b4 = b.double().reshape(*b.shape[:-2], nb, 8, b.shape[-1])
    return torch.einsum("...mcj,...cjn->c...mn", a4, b4).float()


def split_mm(a: torch.Tensor, b: torch.Tensor, acc=None, passes: int = 3) -> torch.Tensor:
    """``acc + a @ b`` as the kernels' wgmma sequence forms it: with
    ``passes`` 3 the split TF32 products (``split_ss`` / ``split_rs``), with 1
    one TF32 pass of the unsplit operands.  ``acc`` None: the first product
    overwrites the accumulator."""
    if passes == 3:
        (ah, al), (bh, bl) = split(a), split(b)
        small = torch.stack((_blocks(al, bh), _blocks(ah, bl)), 1).flatten(0, 1)
        steps = torch.cat((small, _blocks(ah, bh)))
    else:
        steps = _blocks(tf32_rna(a), tf32_rna(b))
    out = steps[0] if acc is None else acc + steps[0]
    for step in steps[1:]:
        out = out + step
    return out


# ---- the kernels, modelled ----------------------------------------------------------------

def _padded(d: int) -> int:
    return 32 if d <= 32 else 64 if d <= 64 else -(-d // 32) * 32


def _mask(qpos, kpos, sq, sk, causal, window):
    keep = (qpos < sq) & (kpos < sk)
    if causal:
        keep = keep & (qpos >= kpos)
    if window is not None:
        keep = keep & (qpos - kpos < window)
    return keep


def forward_model(q, k, v, *, causal, window, softcap, scale, passes=3):
    """``flash_attention.cu``'s split kernel: (out, m, l) as it forms them.
    q scaled first; per KV tile of ``kFwdKeys*`` keys S by ``split_mm``, the
    softcap, the mask, the online softmax with each quad thread's share of l
    (columns 8g + 2t + {0, 1}) reduced at the end, O·corr + P·V by
    ``split_mm``; out = O / max(l, 1e-30).  Tiles outside a row's band only
    add what a later correction multiplies by exp(−2e38 − m) = 0, so every row
    walks every tile."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    bk = (_const(FWD_SOURCE, "kFwdKeys128") if _padded(d) == 128
          else _const(FWD_SOURCE, "kFwdKeys64"))
    qs = (q.float() * scale).transpose(1, 2)                              # [B,H,Sq,D]
    kr = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vr = v.float().repeat_interleave(g, 2).transpose(1, 2)
    m = torch.full((b, h, sq), NEG_INF)
    lt = torch.zeros((b, h, sq, 4))           # the four quad threads' shares of l
    acc = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        kt = torch.zeros((b, h, bk, d))
        vt = torch.zeros((b, h, bk, d))
        n = min(bk, sk - k0)
        kt[:, :, :n], vt[:, :, :n] = kr[:, :, k0:k0 + n], vr[:, :, k0:k0 + n]
        s = split_mm(qs, kt.transpose(-1, -2), passes=passes)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + bk)[None, :]
        s = torch.where(_mask(qpos, kpos, sq, sk, causal, window), s, NEG_INF)
        s = torch.where(kpos >= sk, -math.inf, s)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        parts = p.reshape(b, h, sq, bk // 8, 4, 2)
        share = torch.zeros((b, h, sq, 4))
        for gi in range(bk // 8):
            share = share + parts[..., gi, :, 0]
            share = share + parts[..., gi, :, 1]
        lt = lt * corr[..., None] + share
        acc = split_mm(p, vt, acc=acc * corr[..., None], passes=passes)
        m = m_new
    l = (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).contiguous(), m, l


def backward_model(q, k, v, out, m, l, dout, *, causal, window, softcap, scale, passes=3):
    """``flash_attention_bwd.cu``'s split kernels: (dq, dk, dv) as they form
    them.  dK/dV per (batch, KV head, ``kSplitKeys``-key block): the items (G
    heads × ``kSplitQueryTile``-row tiles of the block's band) alternate
    between ``kSplitConsumers`` warpgroups, each summing its own dK, dV, added
    in warpgroup order at the end; dQ per ``kSplitRows``-row block over the
    forward's band of ``kSplitKeyTile``-key tiles, alternating the same way.
    p = exp(s − m)·(1 / max(l, 1e-30)), ds = p·(dp − Δ)·(1 − t²)."""
    keys, bq = _const(BWD_SOURCE, "kSplitKeys"), _const(BWD_SOURCE, "kSplitQueryTile")
    rows, bk = _const(BWD_SOURCE, "kSplitRows"), _const(BWD_SOURCE, "kSplitKeyTile")
    wgs = _const(BWD_SOURCE, "kSplitConsumers")
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf, kf, vf, of = (t.float() for t in (q, k, v, dout))
    delta = (of * out.float()).sum(-1).transpose(1, 2)                     # [B,H,Sq]
    rl = 1.0 / torch.clamp(l, min=1e-30)

    def rows_of(x, start, n, limit):
        o = torch.zeros(x.shape[:-2] + (n, x.shape[-1]))
        stop = min(start + n, limit)
        if stop > start:
            o[..., :stop - start, :] = x[..., start:stop, :]
        return o

    def vec_of(x, start, n, limit, fill=0.0):
        o = torch.full(x.shape[:-1] + (n,), fill)
        stop = min(start + n, limit)
        if stop > start:
            o[..., :stop - start] = x[..., start:stop]
        return o

    def p_ds(raw, dp, keep, m_r, rl_r, dl_r):
        x = raw * scale
        dfac = torch.ones_like(x)
        if softcap is not None:
            t = torch.tanh(x / softcap)
            x, dfac = softcap * t, 1.0 - t * t
        p = torch.where(keep, torch.exp(x - m_r) * rl_r, 0.0)
        return p, torch.where(keep, p * (dp - dl_r) * dfac, 0.0)

    qh = qf.transpose(1, 2)                                                  # [B,H,Sq,D]
    oh = of.transpose(1, 2)
    kh, vh = kf.transpose(1, 2), vf.transpose(1, 2)                         # [B,KV,Sk,D]
    dk = torch.zeros((b, kvh, sk, d))
    dv = torch.zeros((b, kvh, sk, d))
    for k0 in range(0, sk, keys):
        ko, vo = rows_of(kh, k0, keys, sk), rows_of(vh, k0, keys, sk)    # [B,KV,keys,D]
        kpos = torch.arange(k0, k0 + keys)[:, None]
        q_lo = k0 if causal else 0
        q_end = min(sq, k0 + keys - 1 + window) if window is not None else sq
        t_lo = q_lo // bq
        tiles = (q_end - 1) // bq + 1 - t_lo if q_lo < q_end else 0
        acc_k = [torch.zeros((b, kvh, keys, d)) for _ in range(wgs)]
        acc_v = [torch.zeros((b, kvh, keys, d)) for _ in range(wgs)]
        for n in range(g * tiles):
            heads = torch.arange(kvh) * g + n // tiles
            q0 = (t_lo + n % tiles) * bq
            qt = rows_of(qh[:, heads], q0, bq, sq)                        # [B,KV,bq,D]
            ot = rows_of(oh[:, heads], q0, bq, sq)
            st = split_mm(ko, qt.transpose(-1, -2), passes=passes)        # [B,KV,keys,bq]
            dpt = split_mm(vo, ot.transpose(-1, -2), passes=passes)
            qpos = torch.arange(q0, q0 + bq)[None, :]
            keep = _mask(qpos, kpos, sq, sk, causal, window)
            p, ds = p_ds(st, dpt, keep, vec_of(m[:, heads], q0, bq, sq)[..., None, :],
                         vec_of(rl[:, heads], q0, bq, sq, 1.0)[..., None, :],
                         vec_of(delta[:, heads], q0, bq, sq)[..., None, :])
            w = n % wgs
            acc_v[w] = split_mm(p, ot, acc=acc_v[w], passes=passes)
            acc_k[w] = split_mm(ds, qt, acc=acc_k[w], passes=passes)
        tot_k, tot_v = acc_k[0], acc_v[0]
        for w in range(1, wgs):
            tot_k, tot_v = tot_k + acc_k[w], tot_v + acc_v[w]
        n_keys = min(keys, sk - k0)
        dk[:, :, k0:k0 + n_keys] = (tot_k * scale)[:, :, :n_keys]
        dv[:, :, k0:k0 + n_keys] = tot_v[:, :, :n_keys]
    dq = torch.zeros((b, h, sq, d))
    kvr = torch.arange(h) // g
    nk = -(-sk // bk)
    for q0 in range(0, sq, rows):
        qo, oo = rows_of(qh, q0, rows, sq), rows_of(oh, q0, rows, sq)      # [B,H,rows,D]
        qpos = torch.arange(q0, q0 + rows)[:, None]
        m_r = vec_of(m, q0, rows, sq)[..., None]
        rl_r = vec_of(rl, q0, rows, sq, 1.0)[..., None]
        dl_r = vec_of(delta, q0, rows, sq)[..., None]
        hi = min((min(q0 + rows, sq) - 1) // bk + 1, nk) if causal else nk
        lo = max(q0 - window + 1, 0) // bk if window is not None else 0
        acc = [torch.zeros((b, h, rows, d)) for _ in range(wgs)]
        for n in range(max(hi - lo, 0)):
            k0 = (lo + n) * bk
            kt = rows_of(kh[:, kvr], k0, bk, sk)                          # [B,H,bk,D]
            vt = rows_of(vh[:, kvr], k0, bk, sk)
            s = split_mm(qo, kt.transpose(-1, -2), passes=passes)
            dp = split_mm(oo, vt.transpose(-1, -2), passes=passes)
            keep = _mask(qpos, torch.arange(k0, k0 + bk)[None, :], sq, sk, causal, window)
            _, ds = p_ds(s, dp, keep, m_r, rl_r, dl_r)
            acc[n % wgs] = split_mm(ds, kt, acc=acc[n % wgs], passes=passes)
        tot = acc[0]
        for w in range(1, wgs):
            tot = tot + acc[w]
        n_rows = min(rows, sq - q0)
        dq[:, :, q0:q0 + n_rows] = (tot * scale)[:, :, :n_rows]
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


# ---- references ---------------------------------------------------------------------------

def exact(q, k, v, dout, *, causal, window, softcap, scale):
    """The float64 plain function and its gradients (autograd in float64)."""
    g = q.shape[2] // k.shape[2]
    q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
    kr, vr = k64.repeat_interleave(g, 2), v64.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q64, kr) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    sq, sk = q.shape[1], k.shape[1]
    keep = _mask(torch.arange(sq)[:, None], torch.arange(sk)[None, :], sq, sk, causal, window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    grads = torch.autograd.grad(out, (q64, k64, v64), dout.double())
    return out.detach(), grads


def _inputs(case, seed=0, q_scale=1.0):
    b, s, kv, g, d = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, kv * g, d), np.float32) * np.float32(q_scale),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv * g, d), np.float32)]
    return [torch.from_numpy(a) for a in arrs]


def _opts(case):
    causal, window, softcap = case[5:8]
    return dict(causal=causal, window=window, softcap=softcap, scale=case[4] ** -0.5)


def _softcap_case(c):
    b, s, kv, g, d, window, cap, q_scale = c
    return (b, s, kv, g, d, True, window, cap), q_scale


def _fwd_distances(case, q_scale=1.0, one_pass=True):
    q, k, v, do = _inputs(case, q_scale=q_scale)
    kw = _opts(case)
    want, _ = exact(q, k, v, do, **kw)
    plain = flash_attention_ref(q, k, v, **kw)
    split3 = forward_model(q, k, v, **kw)[0]
    dist = lambda a, b_: float((a.double() - b_.double()).abs().max())  # noqa: E731
    res = dict(model_f64=dist(split3, want), plain_f64=dist(plain, want),
               model_plain=dist(split3, plain), one_pass_plain=math.nan)
    if one_pass:
        res["one_pass_plain"] = dist(forward_model(q, k, v, passes=1, **kw)[0], plain)
    return res


FWD_SPLIT_MAX_D = _const(FWD_SOURCE, "kSplitMaxD")
BWD_SPLIT_MAX_D = _const(BWD_SOURCE, "kSplitMaxD")
# FLASH_CASES where the split kernel serves them; all of FLASH_SOFTCAP_CASES (at D = 256 the
# model shows what a split kernel there would do: the route keeps the CUDA cores).
FWD_CASES = ([(c, 1.0) for c in FLASH_CASES if c[4] <= FWD_SPLIT_MAX_D]
             + [_softcap_case(c) for c in FLASH_SOFTCAP_CASES] + [(LLAMA_REDUCED, 1.0)])


@pytest.mark.parametrize("case,q_scale", FWD_CASES, ids=[f"{c[0]}x{c[1]:g}" for c in FWD_CASES])
def test_forward_model_within_float32_tolerance(case, q_scale):
    """The split model's forward is within 2e-5 of the float64 function and
    of the plain float32 version (phase 5's comparison), and no more than
    FACTOR times as far from float64 as the plain version (floor: one fp32
    ulp of the output's scale)."""
    split_route = case[4] <= FWD_SPLIT_MAX_D
    r = _fwd_distances(case, q_scale, one_pass=split_route)
    print(f"forward {case} q x{q_scale:g}: model vs plain fp32 {r['model_plain']:.3g} "
          f"(phase 5's tol {FWD_TOL}), vs float64 {r['model_f64']:.3g}, plain fp32 vs "
          f"float64 {r['plain_f64']:.3g}; one pass vs plain {r['one_pass_plain']:.3g}; route "
          f"{'split TF32' if split_route else 'CUDA cores'}")
    assert r["model_f64"] <= FWD_TOL
    assert r["model_f64"] <= FACTOR * r["plain_f64"] + 2 ** -23
    if split_route:
        assert r["model_plain"] <= FWD_TOL


# FLASH_CASES where the split kernels serve the backward, and llama's reduced shape.
BWD_CASES = [c for c in FLASH_CASES if c[4] <= BWD_SPLIT_MAX_D] + [LLAMA_REDUCED]


def _bwd_distances(case, q_scale=1.0):
    q, k, v, do = _inputs(case, seed=1, q_scale=q_scale)
    kw = _opts(case)
    _, want = exact(q, k, v, do, **kw)
    out, m, l = forward_model(q, k, v, **kw)
    plain = flash_attention_bwd(q, k, v, out, m, l, do, q_chunk=1024, kv_chunk=1024, **kw)
    split3 = backward_model(q, k, v, out, m, l, do, **kw)
    one = backward_model(q, k, v, out, m, l, do, passes=1, **kw)
    res = {}
    for name, got, ref, pl, on in zip(("dq", "dk", "dv"), split3, want, plain, one):
        scale = float(ref.abs().max())
        res[name] = dict(
            model_f64=float((got.double() - ref).abs().max()) / scale,
            plain_f64=float((pl.double() - ref).abs().max()) / scale,
            model_plain=float((got - pl).abs().max()) / float(pl.abs().max()),
            one_pass_plain=float((on - pl).abs().max()) / float(pl.abs().max()))
    return res


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_backward_model_within_float32_tolerance(case):
    """Each gradient of the split model is within 1e-4 of its max |g| of the
    float64 gradients and of the plain float32 backward on the same forward
    stats (phase 5b's comparison), and no more than FACTOR times as far from
    float64 as the plain backward (floor: 2^-22 of max |g|)."""
    r = _bwd_distances(case)
    for name, x in r.items():
        print(f"backward {case} {name}: model vs plain fp32 {x['model_plain']:.3g} of max |g| "
              f"(phase 5b's tol {BWD_TOL}), vs float64 {x['model_f64']:.3g}, plain fp32 vs "
              f"float64 {x['plain_f64']:.3g}; one pass vs plain {x['one_pass_plain']:.3g}")
        assert x["model_plain"] <= BWD_TOL and x["model_f64"] <= BWD_TOL, name
        assert x["model_f64"] <= FACTOR * x["plain_f64"] + 2 ** -22, name


@pytest.mark.parametrize("case", [FLASH_CASES[1], LLAMA_REDUCED, FLASH_CASES[4]],
                         ids=["g2_d64", "llama_reduced", "softcap_d64"])
def test_one_pass_tf32_misses_the_tolerances(case):
    """One TF32 pass (10 mantissa bits an operand) is far outside both
    float32 tolerances on the same inputs, where the split model is inside."""
    fwd = _fwd_distances(case)
    assert fwd["one_pass_plain"] > 10 * FWD_TOL > 10 * fwd["model_plain"]
    bwd = _bwd_distances(case)
    assert max(x["one_pass_plain"] for x in bwd.values()) > 2 * BWD_TOL
    assert max(x["model_plain"] for x in bwd.values()) < BWD_TOL / 10


def test_tf32_rounding_and_split():
    """``tf32_rna`` is cvt.rna's rounding: TF32 values stay, a value halfway
    between two TF32 neighbours goes away from zero, the error is at most half
    a TF32 ulp (2^-11 relative); hi + lo keeps x to 2^-21 of |x| and
    mostly to 2^-22."""
    one = torch.tensor([1.0, -1.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(one), one)
    half_ulp = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_rna(half_ulp).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    below = torch.tensor([1.0 + 2.0 ** -11 - 2.0 ** -23], dtype=torch.float32)
    assert tf32_rna(below).item() == 1.0
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(100_000).astype(np.float32))
    hi, lo = split(x)
    assert ((tf32_rna(x) - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all() and (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert rel.max() <= 2.0 ** -21 and rel.median() <= 2.0 ** -22


def test_routes_follow_the_sources():
    """The op sends float32 at every head_dim 1..256 to the float32 kernels
    (their sources pick split TF32 up to kSplitMaxD, the CUDA cores above), and
    the split kernels' tiles are what the models walk."""
    for d in range(1, ops.MAX_HEAD_DIM + 1):
        assert ops.route(torch.float32, d) == ops.CUDA_CORE
        assert ops.bwd_route(torch.float32, d) == ops.CUDA_CORE_BWD
    assert _const(FWD_SOURCE, "kSplitMaxD") == 128 and _const(BWD_SOURCE, "kSplitMaxD") == 64
    assert _const(FWD_SOURCE, "kFwdKeys64") % 8 == 0 and _const(FWD_SOURCE, "kFwdKeys128") % 8 == 0
    assert _const(BWD_SOURCE, "kSplitQueryTile") % 32 == 0   # a transposed tile's 32-key boxes
    assert _const(BWD_SOURCE, "kSplitKeyTile") % 32 == 0


@pytest.mark.parametrize("dp", [32, 64, 128])
def test_forward_split_instantiations_within_budget(dp):
    """Each split-TF32 forward instantiation (head_dim zero-padded to DP = 32,
    64 or 128) fits the 232,448 bytes a block can have, from the constants of
    its source (``Split<DP>``: each consumer warpgroup's Q hi / lo, the ring's
    K and Vᵀ hi / lo, the raw K and V, 2·kSplitStages mbarriers, 1024 bytes of
    alignment), and the registers it moves with setmaxnreg fit what the launch
    allocates."""
    s = FWD_SOURCE
    rows = _const(s, "kFwdRows128") if dp == 128 else _const(s, "kFwdRows64")
    bk = _const(s, "kFwdKeys128") if dp == 128 else _const(s, "kFwdKeys64")
    wg, stages = rows // 64, _const(s, "kSplitStages")
    smem = wg * 2 * 64 * dp * 4 + stages * 4 * bk * dp * 4 + 2 * bk * dp * 4 + 64 + 1024
    assert smem <= _const(s, "kSmemBudget") == 232448
    assert rows % 64 == 0 and bk % 32 == 0 and stages >= 2
    if wg == 2:
        assert 128 * _const(s, "kProducerRegs") + 256 * _const(s, "kConsumerRegs") <= 384 * 168
