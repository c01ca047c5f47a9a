"""Bidiagonal -> singular values: the three diagonalizers of
``svdsolver_tpu/models/diagonalize.py`` in PyTorch.

* implicit-shift QR with deflation (Demmel-Kahan 1990; the reference's
  ``impl_zero_shift``, ``diag_reduce_fixed_iter``, ``qrd`` and
  ``Criteria``, svd_serial.h:137-422): :func:`zero_shift_sweep_plain`,
  :func:`shifted_sweep_plain`, :func:`convergence_threshold_plain`,
  :func:`qr_converge_plain`, :func:`bidiagonal_svdvals_plain`;
* shifted dqds (the LAPACK ``dlasq2/3/4`` logic): :func:`dqds_svdvals_plain`;
* parallel bisection on the Golub-Kahan tridiagonal: :func:`bisect_svdvals`.

The QR and dqds diagonalizers are here only as plain versions.  Their
entry points, under the JAX package's names, are in
``ops/cuda/bidiag_qr.py`` and ``ops/cuda/dqds.py``: a CPU tensor runs the
plain version, a CUDA tensor a kernel that runs the whole loop on the card,
the counterpart of the loop XLA compiles to one device program in the JAX
package.  The plain versions are the sequential recurrences written with
0-d tensors in the input's dtype (never Python floats: those are float64),
in the JAX expressions' order of operations, and host-side control flow
where the JAX package has ``lax.cond`` / ``while_loop``; the kernels repeat
that arithmetic bit for bit.
"""

import math

import torch

from svdsolver_tpu_torch.ops.givens import rotation

plain_loops = 0  # runs of a plain QR driver or dqds loop since the last reset
safety_nets = 0  # dqds runs that ended unconverged and took the bisection


class _Scalars:
    """The 0-d constants of one dtype and device the recurrences use."""

    def __init__(self, t):
        finfo = torch.finfo(t.dtype)

        def c(x):
            return torch.tensor(x, dtype=t.dtype, device=t.device)

        self.zero, self.one, self.two, self.three = c(0.0), c(1.0), c(2.0), c(3.0)
        self.eps, self.tiny = c(finfo.eps), c(finfo.tiny)


# ---- implicit-shift QR -------------------------------------------------------


def zero_shift_sweep_plain(d, e, lo=None, hi=None):
    """One Demmel-Kahan implicit zero-shift QR sweep over ``d[lo:hi+1]``;
    returns new ``(d, e)``.

    ``d``: diagonal (n); ``e``: superdiagonal (n - 1); ``lo``/``hi``
    (inclusive d-indices, default the full range) bound the unreduced
    block.  Recurrence as in the reference (svd_serial.h:318-333):
        rot  = givens(c * d[k], e[k]);     e[k-1] = r * s_   (k > lo)
        rot_ = givens(c_ * r, d[k+1] * s); d[k]   = r_
    finalized with  h = c*d[hi];  e[hi-1] = h*s_;  d[hi] = h*c_.
    """
    n = d.shape[0]
    lo = 0 if lo is None else int(lo)
    hi = n - 1 if hi is None else int(hi)
    if hi <= lo:
        return d.clone(), e.clone()
    k_ = _Scalars(d)
    ds, es = list(d.unbind()), list(e.unbind())
    c, s, c_, s_ = k_.one, k_.zero, k_.one, k_.zero
    for k in range(lo, hi):
        c1, s1, r1 = rotation(c * ds[k], es[k], k_.one, k_.zero)
        if k > lo:
            es[k - 1] = r1 * s_
        c2, s2, r2 = rotation(c_ * r1, ds[k + 1] * s1, k_.one, k_.zero)
        ds[k] = r2
        c, s, c_, s_ = c1, s1, c2, s2
    h = c * ds[hi]
    es[hi - 1] = h * s_
    ds[hi] = h * c_
    return torch.stack(ds), torch.stack(es)


def _sigma_min_2x2(f, g, h, k_):
    """Smaller singular value of ``[[f, g], [0, h]]`` (LAPACK ``dlas2``-style,
    branchless); the shift of the implicit QR step."""
    fa, ga, ha = torch.abs(f), torch.abs(g), torch.abs(h)
    fhmn = torch.minimum(fa, ha)
    fhmx = torch.maximum(fa, ha)
    safe_fhmx = torch.where(fhmx == 0, k_.one, fhmx)
    safe_ga = torch.where(ga == 0, k_.one, ga)
    # branch ga <= fhmx
    as_ = fhmn / safe_fhmx + 1
    at = (fhmx - fhmn) / safe_fhmx
    x = ga / safe_fhmx
    au1 = x * x
    c1 = k_.two / (torch.sqrt(as_ * as_ + au1) + torch.sqrt(at * at + au1))
    ss1 = fhmn * c1
    # branch ga > fhmx
    au2 = fhmx / safe_ga
    y, z = as_ * au2, at * au2
    c2 = k_.one / (torch.sqrt(y * y + 1) + torch.sqrt(z * z + 1))
    ss2 = torch.where(au2 == 0, fhmn * fhmx / safe_ga, (fhmn * c2) * au2 * 2)
    ssmin = torch.where(ga <= fhmx, ss1, ss2)
    return torch.where(fhmn == 0, k_.zero, ssmin)


def shifted_sweep_plain(d, e, lo, hi, shift):
    """One implicit-shift QR sweep (Golub-Kahan SVD step) on ``d[lo:hi+1]``:
    LAPACK ``dbdsqr``'s shifted forward path; returns new ``(d, e)``."""
    lo, hi = int(lo), int(hi)
    if hi <= lo:
        return d.clone(), e.clone()
    k_ = _Scalars(d)
    shift = torch.as_tensor(shift, dtype=d.dtype, device=d.device)
    ds, es = list(d.unbind()), list(e.unbind())
    dl = ds[lo]
    sgn = torch.where(dl >= 0, k_.one, -k_.one)
    safe_dl = torch.where(dl == 0, k_.one, dl)
    f = (torch.abs(dl) - shift) * (sgn + shift / safe_dl)
    g = es[lo]
    for i in range(lo, hi):
        cosr, sinr, r = rotation(f, g, k_.one, k_.zero)
        if i > lo:
            es[i - 1] = r
        f2 = cosr * ds[i] + sinr * es[i]
        es[i] = cosr * es[i] - sinr * ds[i]
        g2 = sinr * ds[i + 1]
        ds[i + 1] = cosr * ds[i + 1]
        cosl, sinl, r2 = rotation(f2, g2, k_.one, k_.zero)
        ds[i] = r2
        f = cosl * es[i] + sinl * ds[i + 1]
        ds[i + 1] = cosl * ds[i + 1] - sinl * es[i]
        if i < hi - 1:
            g = sinl * es[i + 1]
            es[i + 1] = cosl * es[i + 1]
    es[hi - 1] = f
    return torch.stack(ds), torch.stack(es)


def convergence_threshold_plain(d, e, tol_factor=100.0):
    """Demmel-Kahan deflation threshold (reference: Criteria,
    svd_serial.h:137): ``max(tol * lbound, 0.5 * eps * ||B||_bound, tiny)``
    with ``tol = tol_factor * eps`` and ``lbound`` from the lambda/mu
    singular-value lower-bound recurrences (DK 1990, p.20).

    The absolute floor: sigma_min of a random bidiagonal is exponentially
    small in n, so ``tol * lbound`` underflows past anything the sweeps can
    resolve and deflation would rely on literal underflow; the sweeps'
    roundoff bounds attainable accuracy at ~eps*||B||, so deflating at half
    that loses nothing real (the JAX package's comment at
    ``diagonalize.py:106-115`` has the measurement).
    """
    k_ = _Scalars(d)
    ad, ae = torch.abs(d), torch.abs(e)
    a, b = ad.unbind(), ae.unbind()
    n = d.shape[0]
    mu, lam, mus, lams = a[0], a[-1], [], []
    for j in range(n - 1):
        # mu[j+1] = |d[j+1]| mu[j] / (mu[j] + |e[j]|); lambda from the bottom
        mu = a[j + 1] * (mu / (mu + b[j]))
        mus.append(mu)
        i = n - 2 - j
        lam = a[i] * (lam / (lam + b[i]))
        lams.append(lam)
    lbound = torch.minimum(
        torch.minimum(torch.stack(mus).min(), ad[0]),
        torch.minimum(torch.stack(lams).min(), ad[-1]),
    )
    tol = torch.tensor(tol_factor, dtype=d.dtype, device=d.device) * k_.eps
    smax_b = ad.max() + torch.cat([ae, ae[:1] * 0]).max()
    floor = 0.5 * k_.eps * smax_b
    return torch.maximum(torch.maximum(tol * lbound, floor), k_.tiny)


def _qr_chunk_plain(d, e, thresh, max_sweeps):
    """Up to ``max_sweeps`` QR deflation sweeps on {d, e} at the fixed
    ``thresh``; returns ``(d, e, sweeps, converged)``.  Each sweep hard-zeroes
    every ``|e| <= thresh``, locates the bottom-most unreduced block
    ``[lo, hi]`` and runs one shifted sweep on it, or a zero-shift sweep
    where the shift would spoil relative accuracy (``dbdsqr``'s test
    ``(shift / |d[lo]|)^2 < eps``)."""
    k_ = _Scalars(d)
    idx = torch.arange(e.shape[0], device=d.device)
    sweeps = 0
    while sweeps < max_sweeps:
        live = torch.abs(e) > thresh
        if not bool(live.any()):
            break
        e = torch.where(live, e, k_.zero)
        hi_e = int(torch.where(live, idx, -1).max())
        dead_below = (idx < hi_e) & ~live
        lo = int(torch.where(dead_below, idx + 1, 0).max())
        hi = hi_e + 1
        shift = _sigma_min_2x2(d[max(hi - 1, 0)], e[hi_e], d[hi], k_)
        sll = torch.abs(d[lo])
        x = shift / torch.where(sll == 0, k_.one, sll)
        if bool((sll == 0) | (x * x < k_.eps)):
            d, e = zero_shift_sweep_plain(d, e, lo, hi)
        else:
            d, e = shifted_sweep_plain(d, e, lo, hi, shift)
        sweeps += 1
    return d, e, sweeps, not bool((torch.abs(e) > thresh).any())


def qr_converge_plain(d, e, max_sweeps=None, chunk_sweeps=None):
    """The deflation loop of ``bidiagonal_svdvals`` in plain PyTorch, in
    chunks of ``chunk_sweeps`` (default: one chunk), each resuming where the
    last stopped, so every chunking gives the same bits.  Returns ``(d, e,
    thresh, sweeps, converged)``."""
    global plain_loops
    n = d.shape[0]
    max_sweeps = 30 * n if max_sweeps is None else int(max_sweeps)
    chunk = max_sweeps if chunk_sweeps is None else max(int(chunk_sweeps), 1)
    plain_loops += 1
    thresh = convergence_threshold_plain(d, e)
    done = sweeps = 0
    converged = False
    while done < max_sweeps:
        k = min(chunk, max_sweeps - done)
        d, e, ran, converged = _qr_chunk_plain(d, e, thresh, k)
        done += k
        sweeps += ran
        if converged:
            break
    return d, e, thresh, sweeps, converged


def bidiagonal_svdvals_plain(d, e, max_sweeps=None, chunk_sweeps=None):
    """``ops.cuda.bidiag_qr.bidiagonal_svdvals`` in plain PyTorch
    (:func:`qr_converge_plain`)."""
    if d.shape[0] == 1:
        return torch.abs(d)
    d = qr_converge_plain(d, e, max_sweeps, chunk_sweeps)[0]
    return torch.sort(torch.abs(d)).values.flip(0)


# ---- dqds ---------------------------------------------------------------------

# dlasq4's constants (LAPACK dlasq4.f): CNST1 = 9/16 bounds the
# Rayleigh-residual norm estimate below which the refined shift is trusted;
# CNST2/CNST3 are its safety inflation factors.
CNST1, CNST2, CNST3 = 0.5625, 1.01, 1.05
HIST_BINS = 19  # ttype histogram, indexed by -ttype (18: corrected retries)


def dqds_prepare(d, e):
    """The scaled qd arrays: ``q = (d / s)^2``, ``E = (e / s)^2`` padded with
    one unused zero, and ``s = max(|d|, |e|)`` (1 where that is 0)."""
    scale = torch.maximum(torch.abs(d).max(), torch.abs(e).max())
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q0 = (d / scale) * (d / scale)
    E0 = torch.nn.functional.pad((e / scale) * (e / scale), (0, 1))
    return q0.contiguous(), E0.contiguous(), scale


def dqds_finish(d, e, out, hi, scale, net=None):
    """Singular values from the flushed eigenvalue estimates ``out``, or,
    when the loop ended unconverged (``hi >= 0``: stuck, capped, or a failed
    zero-shift sweep), from the bisection ``net`` (default
    :func:`bisect_svdvals`) on the same {d, e}: the normwise safety net of
    the JAX package (``diagonalize.py:962-965``)."""
    global safety_nets
    sig = scale * torch.sort(torch.sqrt(torch.clamp_min(out, 0))).values.flip(0)
    if hi < 0:
        return sig
    safety_nets += 1
    return (net or bisect_svdvals)(d.contiguous(), e.contiguous())


def _dqds_sweep_plain(q, E, lo, hi, tau, k_):
    """One dqds sweep over the window ``[lo, hi]`` at shift ``tau``; returns
    ``(q', E', dmin, dn, dmin1, dn1, dmin2, dn2, ok)``: ``dn`` the bottom
    pivot, ``dn1``/``dn2`` the pivots at ``hi - 1`` / ``hi - 2``,
    ``dmin1``/``dmin2`` the least pivots without the last one / two, and
    ``ok`` (a bool) that every pivot stayed positive and finite.

    The JAX package runs the step over the whole array under an ``active``
    mask, and records ``dn1``/``dn2`` at ``i = hi - 2`` / ``hi - 3`` even
    where that step is masked (``i < lo``): there the carried pivot is still
    the first one, ``dd0``, and this repeats that step's value."""
    w = hi - lo
    qw, Ew = q[lo:hi + 1].unbind(), E[lo:hi].unbind()
    dd = dd0 = qw[0] - tau

    def masked(i):  # the value the masked step i < lo records
        qq = dd0 + E[i]
        return dd0 * (q[i + 1] / torch.where(qq == 0, k_.tiny, qq)) - tau

    qs, es, ddns = [], [], []
    for j in range(w):
        qq = dd + Ew[j]
        t = qw[j + 1] / torch.where(qq == 0, k_.tiny, qq)
        es.append(Ew[j] * t)
        qs.append(qq)
        dd = dd * t - tau
        ddns.append(dd)
    piv = torch.stack(ddns)
    dmin = torch.minimum(dd0, piv.min())
    dmin1 = torch.minimum(dd0, piv[:w - 1].min()) if w > 1 else dd0
    dmin2 = torch.minimum(dd0, piv[:w - 2].min()) if w > 2 else dd0
    dn1 = piv[w - 2] if w >= 2 else (masked(hi - 2) if hi >= 2 else dd0)
    dn2 = piv[w - 3] if w >= 3 else (masked(hi - 3) if hi >= 3 else dd0)
    ok = bool((torch.stack(qs) > 0).all() & (dmin >= 0) & torch.isfinite(dd))
    qs.append(dd)  # q[hi] <- the final pivot
    q, E = q.clone(), E.clone()
    q[lo:hi + 1] = torch.stack(qs)
    E[lo:hi] = torch.stack(es)
    return q, E, dmin, dd, dmin1, dn1, dmin2, dn2, ok


def _dqds_loop_plain(q, E, max_sweeps):
    """The dqds state machine of ``dqds_svdvals`` (``diagonalize.py:413-958``)
    on the scaled ``q``, ``E``; returns ``(out, hi, sweeps, histogram)`` with
    ``out`` flushed (``q + accumulated shift`` where unconverged)."""
    n = q.shape[0]
    k_ = _Scalars(q)
    zero, eps, tiny = k_.zero, k_.eps, k_.tiny
    tol2 = (100 * eps) * (100 * eps)
    eps2 = eps * eps
    f4 = 4 * eps + 1
    idx = torch.arange(n, device=q.device)
    accv = torch.zeros_like(q)
    out = torch.zeros_like(q)
    th = [0] * HIST_BINS
    hi, it, since, stuck, tt = n - 1, 0, 0, False, 0
    dmin = dn = dm1 = dn1v = dm2 = dn2v = zero
    g = torch.tensor(0.25, dtype=q.dtype, device=q.device)

    def sq(x):
        return torch.sqrt(torch.clamp_min(x, 0))

    while hi >= 0 and it < max_sweeps and not stuck:
        hi_in = hi
        # split: the window's lower edge is one past the bottom-most
        # negligible E below hi (dlasq2's test, tol = 100 eps); negligible
        # E are hard-zeroed, so splits are permanent
        qnext = torch.cat([q[1:], q[-1:]])
        eneg = (E <= tol2 * accv + eps2 * torch.maximum(q, qnext) + tiny) & (idx < hi)
        E = torch.where(eneg, zero, E)
        lo = int(torch.where(eneg, idx + 1, 0).max())

        # dlasq3's deflation loop: strip one or two eigenvalues off the
        # bottom until nothing fires
        while hi >= 0:
            him1, him2 = max(hi - 1, 0), max(hi - 2, 0)
            qh, q1, q2 = q[hi], q[him1], q[him2]
            e1, e2, ah = E[him1], E[him2], accv[hi]
            if hi == lo or bool((e1 <= tol2 * (ah + qh)) | (e1 <= tol2 * q1)
                                | (e1 <= eps2 * torch.maximum(qh, q1) + tiny)):
                out[hi] = qh + ah
                E[him1] = zero
                hi -= 1
                continue
            if hi - 1 < lo or not (hi - 1 == lo or bool(
                    (e2 <= tol2 * ah) | (e2 <= tol2 * q2)
                    | (e2 <= eps2 * torch.maximum(q1, q2) + tiny))):
                break
            # exact trailing-2x2 deflation (dlasq3 label 40)
            bs, as_ = torch.minimum(q1, qh), torch.maximum(q1, qh)
            t = 0.5 * ((as_ - bs) + e1)
            tm = torch.maximum(t, tiny)
            s0 = bs * (e1 / tm)
            s1 = torch.where(
                s0 <= t,
                bs * (e1 / torch.maximum(t * (torch.sqrt(s0 / tm + 1) + 1), tiny)),
                bs * (e1 / torch.maximum(t + torch.sqrt(t) * torch.sqrt(t + s0), tiny)),
            )
            tbig = as_ + (s1 + e1)
            refine = (e1 > bs * tol2) & (t != 0)
            out[hi] = torch.where(refine, bs * (as_ / torch.maximum(tbig, tiny)), bs) + ah
            out[him1] = torch.where(refine, tbig, as_) + accv[him1]
            E[him1] = zero
            E[him2] = zero
            hi -= 2
        # progress guard: no deflation for 60 sweeps -> stuck
        since = 0 if hi < hi_in else since + 1
        stuck = stuck or since > 60

        # dlasq2's CBIAS flip of a window with its large values at the
        # bottom; the pivot stats describe the old orientation: reset
        if hi - lo >= 2 and bool(1.5 * q[lo] < q[hi]):
            q, E = q.clone(), E.clone()
            q[lo:hi + 1] = q[lo:hi + 1].flip(0)
            E[lo:hi] = E[lo:hi].flip(0)
            dmin = dn = dm1 = dn1v = dm2 = dn2v = zero
            tt = 0

        if hi - lo < 1:
            it += 1
            continue
        # ---- shift: dlasq4's battery, dispatched on the eigenvalues
        # deflated since the last sweep and where its least pivot was
        ndefl = min(hi_in - hi, 2)
        him1, him2, him3 = max(hi - 1, 0), max(hi - 2, 0), max(hi - 3, 0)
        at_dn = bool(dn <= dmin * f4)
        at_dn1 = bool(dn1v <= dmin * f4)
        at_dn2 = bool(dn2v <= dmin * f4)
        m1_at = bool(dn1v <= dm1 * f4)
        m2_at = bool(dn2v <= dm2 * f4)

        def norm_tail(start, b, a):
            # dlasq4's norm-squared estimate from row start up to lo;
            # invalid on any E[i] > q[i]
            i = start
            while i >= lo:
                qi = torch.maximum(q[max(i, 0)], tiny)
                Ei = E[max(i, 0)]
                if bool(Ei > qi):
                    return a, False
                bn = b * (Ei / qi)
                an = a + bn
                stop = bool((100.0 * torch.maximum(bn, b) < an) | (an > CNST1) | (bn == 0))
                a, b = an, bn
                if stop:
                    break
                i -= 1
            return a, True

        def refined(dmx, gap2, a2f):
            # cases 7/8 and 10: the Rayleigh-residual refinement of dmx / 3
            b2s = torch.sqrt(CNST3 * a2f)
            a2v = dmx / (b2s * b2s + 1)
            gap2 = gap2(a2v)
            wide = bool((gap2 > 0) & (gap2 > b2s * a2v))
            if wide:
                ref = a2v * (1 - CNST2 * a2v * (b2s / torch.maximum(gap2, tiny)) * b2s)
            else:
                ref = a2v * (1 - CNST2 * b2s)
            return ref, wide

        gn = g
        if ndefl == 0 and (at_dn or at_dn1) and at_dn and m1_at:
            # cases 2/3: the twisted asymptotic, a 2x2-perturbation shift
            b1 = sq(q[hi]) * sq(E[him1])
            b2 = sq(q[him1]) * sq(E[him2])
            a2 = q[him1] + E[him1]
            gap2 = dm2 - a2 - 0.25 * dm2
            gap1 = torch.where((gap2 > 0) & (gap2 > b2), a2 - dn - (b2 / gap2) * b2,
                               a2 - dn - (b1 + b2))
            s2 = torch.maximum(dn - (b1 / torch.maximum(gap1, tiny)) * b1, 0.5 * dmin)
            s3 = torch.where(dn > b1, dn - b1, zero)
            s3 = torch.where(a2 > b1 + b2, torch.minimum(s3, a2 - (b1 + b2)), s3)
            s3 = torch.maximum(s3, dmin / k_.three)
            use2 = bool((gap1 > 0) & (gap1 > b1))
            tau, ttn = (s2, -2) if use2 else (s3, -3)
        elif ndefl == 0 and (at_dn or at_dn1):
            # case 4: least pivot at dn or dn1, the residual bound
            if at_dn:
                gam = dn
                b2i = E[him1] / torch.maximum(q[him1], tiny)
                a2i, start = b2i, hi - 2
                pre_ok = bool(E[him1] <= q[him1])
            else:
                gam = dn1v
                b2i = E[him2] / torch.maximum(q[him2], tiny)
                a2i, start = E[him1] / torch.maximum(q[hi], tiny) + b2i, hi - 3
                pre_ok = bool((E[him1] <= q[hi]) & (E[him2] <= q[him2]))
            a2f, valid = norm_tail(start, b2i, a2i)
            a2f = CNST3 * a2f
            if pre_ok and valid and bool(a2f < CNST1):
                tau = gam * (1 - torch.sqrt(a2f)) / (a2f + 1)
            else:
                tau = 0.25 * dmin
            ttn = -4
        elif ndefl == 0 and at_dn2:
            # case 5: least pivot at dn2
            pre_ok = bool((E[him2] <= q[him1]) & (E[him1] <= q[hi]))
            a2i = (E[him1] / torch.maximum(q[hi], tiny)) * (
                E[him2] / torch.maximum(q[him1], tiny) + 1)
            if hi - lo > 2:
                b2i = E[him3] / torch.maximum(q[him3], tiny)
                a2f, valid = norm_tail(hi - 4, b2i, a2i + b2i)
                a2f = CNST3 * a2f
            else:
                a2f, valid = a2i, True
            if pre_ok and valid and bool(a2f < CNST1):
                tau = dn2v * (1 - torch.sqrt(a2f)) / (a2f + 1)
            else:
                tau = 0.25 * dmin
            ttn = -5
        elif ndefl == 0:
            # case 6: interior minimum, g * dmin with dlasq4's G history
            if tt == -6:
                gn = g + (1 - g) / k_.three
            else:
                gn = torch.tensor(1.0 / 12.0 if tt == -18 else 0.25,
                                  dtype=q.dtype, device=q.device)
            tau, ttn = gn * dmin, -6
        elif ndefl == 1 and m1_at and m2_at:
            # cases 7/8: one deflated, dmin1 proxies the shrunk window
            s0 = dm1 / k_.three
            pre_ok = bool(E[him1] <= q[him1])
            b0 = E[him1] / torch.maximum(q[him1], tiny)
            a2f, valid = norm_tail(hi - 2, b0, b0)
            ref, wide = refined(dm1, lambda a2v: 0.5 * dm2 - a2v, a2f)
            tau = torch.maximum(s0, ref) if pre_ok and valid else s0
            ttn = -7 if wide else -8
        elif ndefl == 1:
            # case 9
            tau, ttn = (0.5 * dm1 if m1_at else 0.25 * dm1), -9
        elif m2_at and bool(2 * E[him1] < q[him1]):
            # case 10: two deflated, dmin2 proxies the shrunk window
            s0 = dm2 / k_.three
            pre_ok = bool(E[him1] <= q[him1])
            b0 = E[him1] / torch.maximum(q[him1], tiny)
            a2f, valid = norm_tail(hi - 2, b0, b0)
            ref, _ = refined(
                dm2, lambda a2v: q[him1] + E[him2] - sq(q[him2]) * sq(E[him2]) - a2v, a2f)
            tau = torch.maximum(s0, ref) if pre_ok and valid else s0
            ttn = -10
        else:
            # case 11
            tau, ttn = 0.25 * dm2, -11
        tau = torch.maximum(zero, tau)

        # the sweep; on failure retry at tau + dmin (dlasq3's correction),
        # then at tau = 0; a failed zero-shift sweep keeps the old state
        res = _dqds_sweep_plain(q, E, lo, hi, tau, k_)
        if not res[-1]:
            tau = torch.maximum(zero, tau + res[2])
            res = _dqds_sweep_plain(q, E, lo, hi, tau, k_)
            ttn = -18
            if not res[-1]:
                tau = zero
                res = _dqds_sweep_plain(q, E, lo, hi, tau, k_)
                ttn = 0
        if res[-1]:
            q, E, dmin, dn, dm1, dn1v, dm2, dn2v, _ = res
            accv = accv.clone()
            accv[lo:hi + 1] = accv[lo:hi + 1] + tau
        else:
            ttn = 0
            stuck = True
        th[min(-ttn, HIST_BINS - 1)] += 1
        tt, g = ttn, gn
        it += 1
    out = torch.where(idx <= hi, q + accv, out)  # flush if capped or stuck
    return out, hi, it, th


def dqds_svdvals_plain(d, e, max_sweeps=None, with_info=False):
    """``ops.cuda.dqds.dqds_svdvals`` in plain PyTorch."""
    global plain_loops
    n = d.shape[0]
    if n == 1:
        return dqds_result(torch.abs(d), 0, [0] * HIST_BINS, d, with_info)
    max_sweeps = 60 * n if max_sweeps is None else int(max_sweeps)
    plain_loops += 1
    q0, E0, scale = dqds_prepare(d, e)
    out, hi, it, th = _dqds_loop_plain(q0, E0, max_sweeps)
    return dqds_result(dqds_finish(d, e, out, hi, scale), it, th, d, with_info)


def dqds_result(sig, sweeps, th, d, with_info):
    if with_info == "debug":
        return sig, sweeps, torch.as_tensor(th, dtype=torch.int32, device=d.device)
    if with_info:
        return sig, sweeps
    return sig


# ---- bisection ------------------------------------------------------------------


def tgk_z2_and_bound(d, e):
    """Squared Golub-Kahan off-diagonals and the Gershgorin bound.

    The TGK tridiagonal of the bidiagonal {d, e} has zero diagonal and
    off-diagonals ``z = (d1, e1, d2, e2, ..., d_n)``; its eigenvalues are
    ``+/- sigma``.  Returns ``(z2, bound)`` with ``z2 = max(z*z, tiny)`` (the
    ``tiny`` floor decouples exact splits safely) and ``bound`` a 0-d tensor
    above every sigma.
    """
    n = d.shape[0]
    dtype = d.dtype
    z = d.new_zeros((2 * n - 1,))
    z[0::2] = d
    z[1::2] = e
    z2 = torch.clamp_min(z * z, torch.finfo(dtype).tiny)
    azp = torch.nn.functional.pad(torch.abs(z), (1, 1))
    bound = torch.max(azp[:-1] + azp[1:]) * (1 + 4 * torch.finfo(dtype).eps)
    return z2, bound


def default_bisect_iters(dtype, probes=1):
    """Sweeps for eps-plus-12-bit absolute resolution of the bound:
    ``ceil((-log2 eps + 12) / log2(probes + 1))``."""
    bits = math.ceil(-math.log2(torch.finfo(dtype).eps)) + 12
    return math.ceil(bits / math.log2(probes + 1))


def bisect_svdvals(d, e, iters=None):
    """Singular values of the bidiagonal {d, e} by parallel bisection,
    descending.

    All ``n`` values are bisected simultaneously on the Golub-Kahan
    tridiagonal: one step evaluates a one-sided Sturm pivot count
    ``p <- -lam - z_i^2 / p`` over ``2n - 1`` steps for the n shifts at once.
    Accuracy is absolute, ``~||B|| * 2**-iters``.  Relies on IEEE division
    (a zero pivot gives ``-inf``, counted negative, and the next step
    recovers), so no pivot guard is needed.
    """
    n = d.shape[0]
    if n == 1:
        return torch.abs(d)
    if iters is None:
        iters = default_bisect_iters(d.dtype)
    z2, bound = tgk_z2_and_bound(d, e)
    zs = z2.unbind()  # 0-d views: no indexing op per recurrence step
    lo = d.new_zeros((n,))
    hi = bound.expand(n).clone()
    ks = torch.arange(n, device=d.device)  # lane j targets the j-th smallest
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        p = -mid
        cnt = (p < 0).to(torch.int32)
        for i in range(1, 2 * n):
            p = -mid - zs[i - 1] / p
            cnt += p < 0
        above = (cnt - n) > ks  # TGK eigs below mid minus the n negative ones
        lo, hi = torch.where(above, lo, mid), torch.where(above, mid, hi)
    return (0.5 * (lo + hi)).flip(0)
