"""RNS ring-element data plane ("DoubleCRT"), helib_tpu.dcrt in torch.

A ring element is an int32 residue tensor [..., P, N] kept in the
evaluation (NTT) domain on `ctx.device`; P rows = live primes (prefix of the
ctxt chain + optionally the special primes), N = m for odd m, phi(m) for
power-of-2 m.  Leading dims are a batch: every op broadcasts over them.

  * `rt_scale_down`: pure-RNS scaled mod-down (float-corrected CRT lift of
    the dropped block, BGV "delta = 0 mod p^r" fix-up in RNS);
  * `rt_add_special_and_scale`: scale by P with zero special rows;
  * `rt_break_into_digits`: mixed-radix digits with balanced basis extension.

Both lift a block of coefficient rows onto other primes through
ops.basis_ext (one kernel launch on the card).  The digit decomposition and
the scaled mod-down are helib_tpu's jit sites: one compiled program a
configuration (Context.jit_call; on the card a CUDA-graph replay a call).

The float64 lifts sum their terms left to right, each product and sum
rounded on its own.  XLA:CPU contracts the same sum into fused multiply-adds,
so the float sums can differ in the last bit; the integer lifts taken from
them agree except when a sum lies within ~1e-16 of a rounding boundary.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .context import Context, log2_sum
from .ops import modops
from .ops.basis_ext import basis_ext, basis_ext_tables
from .ops.modops import (add_mod, sub_mod, neg_mod, mul_mod, mul_mod_shoup,
                         to_device, to_host)
from .exceptions import assert_true


# ---------------------------------------------------------------------------
# elementwise ring ops (eval domain; shapes [..., P, N])
# ---------------------------------------------------------------------------

def rt_add(ctx: Context, a, b, k: int, special: bool, own=None):
    q, _ = ctx.dev_q(k, special, own)
    return add_mod(a, b, q)


def rt_sub(ctx: Context, a, b, k: int, special: bool, own=None):
    q, _ = ctx.dev_q(k, special, own)
    return sub_mod(a, b, q)


def rt_neg(ctx: Context, a, k: int, special: bool, own=None):
    q, _ = ctx.dev_q(k, special, own)
    return neg_mod(a, q)


def rt_mul(ctx: Context, a, b, k: int, special: bool, own=None):
    q, mu = ctx.dev_q(k, special, own)
    return mul_mod(a, b, q, mu)


def rt_mul_scalar(ctx: Context, a, value: int, k: int, special: bool,
                  own=None):
    """Multiply by an integer constant (reduced per limb, Shoup)."""
    def build():
        qs = ctx.primes_of(k, special, own).astype(np.uint64)
        w = np.array([value % int(q) for q in qs], dtype=np.uint32)[:, None]
        return (to_device(w, ctx.device),
                to_device(modops.shoup(w, qs[:, None]), ctx.device))
    w, wsh = ctx.cached(("scalar", value, k, special, own), build)
    return mul_mod_shoup(a, w, wsh, ctx.dev_q(k, special, own)[0])


def rt_automorph(ctx: Context, a, kexp: int):
    """f(X) -> f(X^kexp): index permutation along the eval axis."""
    perm = ctx.cached(("perm", kexp), lambda: torch.from_numpy(
        ctx.pal.automorph_perm(kexp).astype(np.int64)).to(ctx.device))
    return a.index_select(-1, perm)


def _rows(ctx: Context, pos) -> torch.Tensor:
    """Cached device index tensor for a tuple of row positions."""
    return ctx.cached(("rows", tuple(pos)), lambda: torch.tensor(
        list(pos), dtype=torch.int64, device=ctx.device))


# ---------------------------------------------------------------------------
# coefficient <-> evaluation domain, integer I/O
# ---------------------------------------------------------------------------

def coeffs_to_residues(ctx: Context, coeffs, rows: tuple) -> np.ndarray:
    """Integer (possibly signed / bignum) coefficient vector -> residue matrix
    [len(rows), N] (host)."""
    qs = ctx.all_q[np.array(rows)]
    N = ctx.n_eval
    out = np.zeros((len(rows), N), dtype=np.uint32)
    arr = np.asarray(coeffs, dtype=object)
    assert_true(len(arr) <= N, (len(arr), N))
    for i, q in enumerate(qs):
        qi = int(q)
        out[i, :len(arr)] = np.array([int(v) % qi for v in arr],
                                     dtype=np.uint32)
    return out


def rt_from_coeffs(ctx: Context, coeffs, k: int, special: bool):
    """Host integer coefficients -> device eval-domain tensor."""
    rows = ctx.rows_of(k, special)
    res = coeffs_to_residues(ctx, coeffs, rows)
    return ctx.fwd_ntt(to_device(res, ctx.device), rows)


def rt_to_coeff_residues(ctx: Context, a, k: int, special: bool):
    """Eval tensor -> coefficient-domain residues (on a's device)."""
    return ctx.inv_ntt(a, ctx.rows_of(k, special))


def crt_reconstruct(ctx: Context, coeff_residues: np.ndarray, rows: tuple,
                    balanced: bool = True) -> np.ndarray:
    """Host: CRT-combine per-limb coefficient residues into (balanced)
    integers (object dtype), through the native combiner when it builds."""
    qs = [int(q) for q in ctx.all_q[np.array(rows)]]
    if balanced:
        from .nt.native import combiner_for
        comb = combiner_for(qs)
        if comb is not None:
            return comb.balanced_ints(coeff_residues)
    Q = 1
    for q in qs:
        Q *= q
    acc = np.zeros(coeff_residues.shape[-1], dtype=object)
    for i, qi in enumerate(qs):
        Qi = Q // qi
        ci = (Qi * pow(Qi % qi, -1, qi)) % Q
        acc = (acc + coeff_residues[i].astype(object) * ci) % Q
    if balanced:
        acc = np.where(acc > Q // 2, acc - Q, acc)
    return acc


# ---------------------------------------------------------------------------
# sampling (host numpy RNG, the same bits as helib_tpu -> device NTT; the
# encryption samplers `*_rt_dev` draw on the device)
# ---------------------------------------------------------------------------

def sample_small(ctx: Context, rng: np.random.Generator):
    """Coefficients in {-1,0,1}: 0 w.p. 1/2, ±1 w.p. 1/4 each.
    Returns (coeffs int64 [N], log2 canonical bound)."""
    N = ctx.n_eval
    u = rng.integers(0, 4, N)
    coeffs = np.where(u == 0, -1, np.where(u == 1, 1, 0)).astype(np.int64)
    return coeffs, ctx.noise_small(0.5)


def sample_gaussian(ctx: Context, rng: np.random.Generator):
    sigma = ctx.eff_stdev()
    coeffs = np.round(rng.normal(0.0, sigma, ctx.n_eval)).astype(np.int64)
    return coeffs, ctx.noise_gaussian(sigma)


def sample_hwt(ctx: Context, rng: np.random.Generator, hwt: int):
    """hwt coefficients of +-1 at distinct positions, the rest 0."""
    N = ctx.n_eval
    coeffs = np.zeros(N, dtype=np.int64)
    idx = rng.choice(N, size=min(hwt, N), replace=False)
    coeffs[idx] = rng.choice([-1, 1], size=len(idx))
    return coeffs, ctx.noise_hwt(hwt)


def _bounded(sampler, ctx: Context, rng, *args, tries: int = 1000):
    """Rejection wrapper: resample until the actual canonical-embedding norm
    is below the sampler's high-probability bound (reference sample.cpp)."""
    from .norms import embedding_largest_coeff_log2
    coeffs = bound = None
    for _ in range(tries):
        coeffs, bound = sampler(ctx, rng, *args)
        actual = embedding_largest_coeff_log2(coeffs, ctx.m, ctx.pal.pow2)
        if actual <= bound:
            return coeffs, bound
    from .log import warning
    warning("bounded sampler: no sample within bound after retries", once=True)
    return coeffs, bound


def sample_small_bounded(ctx: Context, rng: np.random.Generator):
    return _bounded(sample_small, ctx, rng)


def sample_gaussian_bounded(ctx: Context, rng: np.random.Generator):
    return _bounded(sample_gaussian, ctx, rng)


def sample_hwt_bounded(ctx: Context, rng: np.random.Generator, hwt: int):
    return _bounded(sample_hwt, ctx, rng, hwt)


def sample_uniform_residues(ctx: Context, rng: np.random.Generator,
                            k: int, special: bool):
    """Uniform element of R_Q directly in the eval domain (valid because the
    eval map is a bijection on residues)."""
    qs = ctx.primes_of(k, special)
    return to_device(rng.integers(
        0, qs[:, None].astype(np.int64), (len(qs), ctx.n_eval)
    ).astype(np.uint32), ctx.device)


def sample_small_rt_dev(ctx: Context, generator: torch.Generator, k: int,
                        special: bool):
    """Device-side sampleSmall from the caller's torch generator: coeffs in
    {-1, 0, 1} with probabilities 1/4, 1/2, 1/4, lifted to residues and
    transformed (the encryption hot path; keygen keeps the host RNG).  The
    bits differ from helib_tpu's jax.random draw, the distribution does
    not."""
    q, _ = ctx.dev_q(k, special)
    u = torch.randint(0, 4, (ctx.n_eval,), generator=generator,
                      device=ctx.device)
    res = torch.where(u == 0, q - 1, (u == 1).to(torch.int32))   # [P, N]
    return ctx.fwd_ntt(res, ctx.rows_of(k, special)), ctx.noise_small(0.5)


def sample_gaussian_rt_dev(ctx: Context, generator: torch.Generator, k: int,
                           special: bool, mult: int = 1):
    """Device-side rounded Gaussian round(N(0,1) * eff_stdev) * mult from the
    caller's torch generator, lifted to residues and transformed."""
    q, _ = ctx.dev_q(k, special)
    sigma = ctx.eff_stdev()
    g = torch.round(torch.randn(ctx.n_eval, generator=generator,
                                device=ctx.device) * sigma
                    ).to(torch.int64) * mult
    res = torch.remainder(g, q.to(torch.int64)).to(torch.int32)  # [P, N]
    return (ctx.fwd_ntt(res, ctx.rows_of(k, special)),
            math.log2(max(mult, 1)) + ctx.noise_gaussian(sigma))


def small_coeffs_to_rt(ctx: Context, coeffs: np.ndarray, k: int,
                       special: bool):
    """Signed small integer coefficients (len <= N, zero-padded) -> device
    eval tensor."""
    rows = ctx.rows_of(k, special)
    qs = ctx.all_q[np.array(rows)].astype(np.int64)
    c = np.zeros(ctx.n_eval, dtype=np.int64)
    c[:len(coeffs)] = coeffs
    res = (c[None, :] % qs[:, None]).astype(np.uint32)
    return ctx.fwd_ntt(to_device(res, ctx.device), rows)


# ---------------------------------------------------------------------------
# RNS basis extension + scaled mod-down
# ---------------------------------------------------------------------------

def _drop_consts(ctx: Context, drop_rows: tuple, target_rows: tuple,
                 ptxt_space: int) -> dict:
    """Constants for the scaled mod-down dropping `drop_rows`: the lift of
    the dropped block onto the target rows (`lift`), and with a plaintext
    space p^r > 1 onto p^r too, as one more target row: the p^r correction
    reads sum_i y_i (D/d_i) - alpha D mod p^r, the same sum under one more
    modulus."""
    d = ctx.all_q[np.array(drop_rows)].astype(np.uint64)
    t = ctx.all_q[np.array(target_rows)].astype(np.uint64)
    pr = ptxt_space
    if pr > 1:
        assert_true(pr < (1 << 30), "ptxt space too large for RNS mod-down")
    lift = basis_ext_tables(d, np.append(t, np.uint64(pr)) if pr > 1 else t,
                            ctx.device)
    T = len(t)
    out = {"lift": lift, "D_mod_t": lift["D_mod_t"][:T],
           "D_mod_t_sh": lift["D_mod_t_sh"][:T]}
    D = lift["D"]
    Dinv_mod_t = np.array([pow(D % int(tj), -1, int(tj)) for tj in t],
                          dtype=np.uint32)
    out["Dinv_mod_t"] = to_device(Dinv_mod_t[:, None], ctx.device)
    out["Dinv_mod_t_sh"] = to_device(modops.shoup(Dinv_mod_t, t)[:, None],
                                     ctx.device)
    if pr > 1:
        out["Dinv_pr"] = pow(D % pr, -1, pr)
        prD = np.array([(pr * D) % int(tj) for tj in t], dtype=np.uint32)
        out["pr_D_mod_t"] = to_device(prD[:, None], ctx.device)
    return out


def rt_scale_down(ctx: Context, data, k: int, special: bool,
                  new_k: int, new_special: bool, ptxt_space: int,
                  want_frac: bool = False, own=None):
    """One compiled program a configuration (helib_tpu's dcrt.rt_scale_down
    jit site, Context.jit_call) of `_rt_scale_down`; the measured-noise
    read of the remainder stays with the caller."""
    return ctx.jit_call(
        ("scale_down", k, special, new_k, new_special, ptxt_space, want_frac,
         own),
        lambda: lambda v: _rt_scale_down(ctx, v, k, special, new_k,
                                         new_special, ptxt_space, want_frac,
                                         own), data)


def _rt_scale_down(ctx: Context, data, k: int, special: bool,
                   new_k: int, new_special: bool, ptxt_space: int,
                   want_frac: bool = False, own=None):
    """Scaled mod-down (reference Ctxt::modDownToSet, in pure RNS).

    data: [..., P, N] eval tensor on prime set (k, special).  Returns data'
    on (new_k, new_special) with data' = (data - delta)/D where D is the
    product of dropped primes, delta = data (mod D), delta = 0 (mod
    ptxt_space), and delta balanced-small.  want_frac=True also returns the
    balanced delta/D remainder [..., N] (float32) for the measured noise.
    `own` (ctxt rows below k, Context.rows_of): data holds those ctxt rows
    and the specials, as one rank of a limb mesh does; only the replicated
    special primes can be dropped then, each rank lifting them onto its own
    rows alone."""
    assert_true(new_k <= k and (special or not new_special),
                'invariant: new_k <= k and (special or not new_special)')
    assert_true(own is None or new_k == k,
                "a row shard drops only its replicated special primes")
    old_rows = ctx.rows_of(k, special, own)
    new_rows = ctx.rows_of(new_k, new_special, own)
    drop_rows = tuple(r for r in old_rows if r not in new_rows)
    assert_true(drop_rows, "nothing to drop")
    keep_pos = tuple(old_rows.index(r) for r in new_rows)
    drop_pos = tuple(old_rows.index(r) for r in drop_rows)
    cst = ctx.cached(("drop", drop_rows, new_rows, ptxt_space),
                     lambda: _drop_consts(ctx, drop_rows, new_rows,
                                          ptxt_space))
    t_q, _ = ctx.dev_q(new_k, new_special, own)

    x_coeff = ctx.inv_ntt(data.index_select(-2, _rows(ctx, drop_pos)),
                          drop_rows)                        # [..., kd, N]
    # frac_bal: delta0/D in [-1/2, 1/2)
    delta, frac_bal = basis_ext(x_coeff, cst["lift"], want_frac)

    if ptxt_space > 1:
        # v' mod p^r: the lift's last row, under the modulus p^r
        pr, T = ptxt_space, len(new_rows)
        accp = delta[..., T, :].to(torch.int64)
        delta = delta[..., :T, :]
        # eps = -v' * D^{-1} mod p^r, lifted to the balanced range
        eps = ((pr - accp) * cst["Dinv_pr"]) % pr                # [..., N]
        eps_hi = eps > pr // 2
        if want_frac:
            frac_bal = frac_bal + (eps.to(torch.float64)
                                   - eps_hi.to(torch.float64) * float(pr))
        contrib = mul_mod_shoup(eps.to(torch.int32).unsqueeze(-2),
                                cst["D_mod_t"], cst["D_mod_t_sh"], t_q)
        wrap = torch.where(eps_hi.unsqueeze(-2), cst["pr_D_mod_t"],
                           torch.zeros_like(cst["pr_D_mod_t"]))
        delta = add_mod(delta, sub_mod(contrib, wrap, t_q), t_q)

    delta_eval = ctx.fwd_ntt(delta, new_rows)
    kept = data.index_select(-2, _rows(ctx, keep_pos))
    out = mul_mod_shoup(sub_mod(kept, delta_eval, t_q), cst["Dinv_mod_t"],
                        cst["Dinv_mod_t_sh"], t_q)
    if want_frac:
        return out, frac_bal.to(torch.float32)
    return out


def rt_add_special_and_scale(ctx: Context, data, k: int, own=None):
    """modUpToSet(specials): multiply by P = prod(special primes); new rows
    are zero (reference DoubleCRT::addPrimesAndScale).  `own`: as in
    rt_scale_down."""
    scaled = rt_mul_scalar(ctx, data, ctx.prod_special(), k, False, own)
    zeros = scaled.new_zeros(data.shape[:-2] + (ctx.S, data.shape[-1]))
    return torch.cat([scaled, zeros], dim=-2)


# ---------------------------------------------------------------------------
# key-switching digit decomposition
# ---------------------------------------------------------------------------

def _digit_consts(ctx: Context, k: int) -> list:
    """Per digit j at live prefix k: the balanced extension of the digit
    block onto ALL rows (k ctxt + specials), and the running division by the
    FULL digit product (mod live rows)."""
    t = ctx.all_q[np.array(ctx.rows_of(k, True))].astype(np.uint64)
    consts = []
    for j, (s, e) in enumerate(ctx.digit_ranges(k)):
        d = ctx.all_q[s:e].astype(np.uint64)
        entry = basis_ext_tables(d, t, ctx.device)
        fs, fe = ctx.digits[j]
        Df = 1
        for x in ctx.qs[fs:fe]:
            Df *= int(x)
        # inverse undefined on the digit's own primes; those rows of the
        # running value are never read after this digit -- use 1 there.
        Dfinv = np.array([pow(Df % int(tj), -1, int(tj))
                          if Df % int(tj) != 0 else 1 for tj in t[:k]],
                         dtype=np.uint32)
        entry["Dfinv"] = to_device(Dfinv[:, None], ctx.device)
        entry["Dfinv_sh"] = to_device(modops.shoup(Dfinv, t[:k])[:, None],
                                      ctx.device)
        entry["rows"] = (s, e)
        entry["log2_D"] = float(np.sum(np.log2(d.astype(np.float64))))
        consts.append(entry)
    return consts


def _digit_consts_rows(ctx: Context, k: int, own: tuple) -> list:
    """_digit_consts restricted to the rows one rank of a limb mesh holds:
    its ctxt rows `own` and the specials."""
    held = _rows(ctx, tuple(own) + tuple(range(k, k + ctx.S)))
    live = _rows(ctx, tuple(own))
    out = []
    for cst in ctx.cached(("digits", k), lambda: _digit_consts(ctx, k)):
        sub = dict(cst)
        for key, idx, dim in (("M", held, 1), ("M_sh", held, 1),
                              ("t_q", held, 0), ("D_mod_t", held, 0),
                              ("D_mod_t_sh", held, 0),
                              ("Dfinv", live, 0), ("Dfinv_sh", live, 0)):
            sub[key] = cst[key].index_select(dim, idx)
        out.append(sub)
    return out


def rt_break_into_digits(ctx: Context, data, k: int, own=None, gather=None):
    """Mixed-radix digit decomposition (reference DoubleCRT::breakIntoDigits):
    data [..., k, N] on the ctxt prefix (no specials) -> (digits, log2
    noise), digits a list of [..., k+S, N] eval tensors R_j with
    data = sum_j B_j R_j (mod Q_k), B_j = full digit products.

    Runs in the coefficient domain: one inverse transform of the live rows,
    the digit recursion as elementwise ops, and per digit one forward
    transform of its extension rows only; the digit's own rows are the
    running value's eval rows, for free.

    `own` (a contiguous range of ctxt rows below k) and `gather`: data holds
    only those rows, as one rank of a limb mesh does (parallel/mesh.py),
    and the digits come back on them and the specials.  `gather(s, e, x)`
    returns the coefficient rows [s, e) of the whole value from each rank's
    rows of that range (x: this rank's, possibly none): the one exchange
    across limbs, taken digit by digit because digit j's rows depend on the
    digits before it.  Each rank extends each digit onto its own rows and
    the specials alone."""
    if own is None:
        consts = ctx.cached(("digits", k), lambda: _digit_consts(ctx, k))
        # one compiled program a level (helib_tpu's dcrt.rt_break_into_digits
        # jit site, Context.jit_call); the noise bound and the fhe_stats
        # measurement stay outside it, as there
        digits = list(ctx.jit_call(
            ("digits", k), lambda: lambda v: tuple(
                _digits(ctx, v, k, consts, None, None)), data))
    else:
        consts = ctx.cached(("digits", k, own),
                            lambda: _digit_consts_rows(ctx, k, own))
        digits = _digits(ctx, data, k, consts, own, gather)
    noise = log2_sum([ctx.noise_uniform(cst["log2_D"] - 1.0)
                      for cst in consts])
    from . import timing
    if timing.fhe_stats and own is None:
        # noise-model validation: measured canonical-embedding norm of each
        # digit vs the bound charged to the noise estimate (reference
        # HELIB_STATS_UPDATE("break-into-digits-ratio"), DoubleCRT.cpp:548)
        from .norms import embedding_largest_coeff_log2
        held = ctx.rows_of(k, True)
        for dj, cst in zip(digits, consts):
            res = to_host(rt_to_coeff_residues(ctx, dj, k, True))
            if res.ndim > 2:          # batched: measure the first element
                res = res.reshape(-1, *res.shape[-2:])[0]
            coeffs = crt_reconstruct(ctx, res, held)
            norm_log2 = embedding_largest_coeff_log2(coeffs, ctx.m,
                                                     ctx.pal.pow2)
            bound_log2 = ctx.noise_uniform(cst["log2_D"] - 1.0)
            timing.stats_update("break-into-digits-ratio",
                                2.0 ** (norm_log2 - bound_log2))
    return digits, noise


def _digits(ctx: Context, data, k: int, consts: list, own, gather) -> list:
    """The digit recursion of rt_break_into_digits on its constants."""
    if own is None:
        lo, n_own = 0, k
    else:
        lo, n_own = own[0], len(own)
    held = ctx.rows_of(k, True, own)
    live_q = ctx.dev_q(k, False, own)[0]
    cur = ctx.inv_ntt(data, ctx.rows_of(k, False, own))  # [..., n_own, N]
    cur_eval = data                                       # same value, eval
    digits = []
    for j, cst in enumerate(consts):
        s, e = cst["rows"]
        # the digit block's rows held here: positions [a, b) of cur
        a, b = min(max(s - lo, 0), n_own), min(max(e - lo, 0), n_own)
        block = cur[..., a:b, :]
        if own is not None:
            block = gather(s, e, block)
        digit_coeff = basis_ext(block, cst)[0]
        ext_rows = held[:a] + held[b:]
        ext_coeff = torch.cat([digit_coeff[..., :a, :],
                               digit_coeff[..., b:, :]], dim=-2)
        ext_eval = ctx.fwd_ntt(ext_coeff, ext_rows)
        digit_eval = torch.cat([ext_eval[..., :a, :], cur_eval[..., a:b, :],
                                ext_eval[..., a:, :]], dim=-2)
        digits.append(digit_eval)
        if j + 1 < len(consts):
            # cur <- (cur - R_j) / B_j in both domains (pointwise, so the
            # two stay consistent)
            Dfinv, Dfinv_sh = cst["Dfinv"], cst["Dfinv_sh"]
            cur = mul_mod_shoup(
                sub_mod(cur, digit_coeff[..., :n_own, :], live_q),
                Dfinv, Dfinv_sh, live_q)
            cur_eval = mul_mod_shoup(
                sub_mod(cur_eval, digit_eval[..., :n_own, :], live_q),
                Dfinv, Dfinv_sh, live_q)
    return digits
