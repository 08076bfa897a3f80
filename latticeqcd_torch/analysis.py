"""Post-hoc analysis helpers for measurement text files.

A numpy-only copy of latticeqcd_tpu/analysis.py (the port imports
nothing of the JAX package): parse the measurement series written by
the driver; jackknife and Wolff Gamma-method errors; static potential,
Creutz ratios, flow scales and effective masses. Its code below this
docstring is the original's, with the package name in the CLI text.
"""

from __future__ import annotations

import numpy as np


def read_measurement_series(filename, value_columns=(1,)):
    """Read non-comment lines: first column itrj, then values."""
    itrjs, values = [], []
    with open(filename) as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("#")[0].split()
            if not parts:
                continue
            try:
                itrjs.append(int(float(parts[0])))
                values.append([float(parts[c]) for c in value_columns])
            except (ValueError, IndexError):
                continue
    return np.asarray(itrjs), np.asarray(values)


def get_plaquette_average(measuredir, skip: int = 0):
    itrj, vals = read_measurement_series(f"{measuredir}/Plaquette.txt")
    return float(np.mean(vals[skip:, 0]))


def get_polyakov_average(measuredir, skip: int = 0):
    itrj, vals = read_measurement_series(f"{measuredir}/Polyakov_loop.txt", value_columns=(1, 2))
    v = vals[skip:]
    return complex(np.mean(v[:, 0]), np.mean(v[:, 1]))


def jackknife(samples, fn=np.mean, nblocks: int = 10):
    """Blocked jackknife mean and error for a derived quantity."""
    samples = np.asarray(samples)
    n = len(samples) // nblocks * nblocks
    blocks = samples[:n].reshape(nblocks, -1)
    estimates = []
    for i in range(nblocks):
        rest = np.concatenate([blocks[j] for j in range(nblocks) if j != i])
        estimates.append(fn(rest))
    estimates = np.asarray(estimates)
    mean = float(np.mean(estimates))
    err = float(np.sqrt((nblocks - 1) * np.mean((estimates - mean) ** 2)))
    return mean, err


def autocorrelation(samples, s_tau: float = 1.5):
    """Wolff Gamma-method integrated autocorrelation time and error.

    Returns (mean, err, tau_int, w_opt): err is the naive standard
    error inflated by sqrt(2 tau_int), with the summation window W
    chosen by Wolff's automatic criterion (hep-lat/0306017 eq. 52:
    the first W where g(W) = exp(-W/tau(W)) - tau(W)/sqrt(W N) < 0,
    tau(W) from eq. 51 with S = s_tau). tau_int = 0.5 for an
    uncorrelated series; HMC plaquette series typically give 1-10,
    and quoting the naive error without this inflation understates
    the true Monte-Carlo error by sqrt(2 tau_int)."""
    v = np.asarray(samples, dtype=np.float64)
    n = len(v)
    if n < 8:
        m = float(np.mean(v))
        return m, float(np.std(v) / np.sqrt(max(n, 1))), 0.5, 0
    d = v - v.mean()
    # Gamma(t) via FFT (O(N log N))
    fft = np.fft.rfft(np.concatenate([d, np.zeros_like(d)]))
    gamma = np.fft.irfft(fft * np.conj(fft))[: n // 2]
    gamma /= np.arange(n, n - n // 2, -1)
    if gamma[0] <= 0:
        m = float(np.mean(v))
        return m, 0.0, 0.5, 0
    rho = gamma / gamma[0]
    tau = 0.5
    w_opt = n // 2 - 1
    for w in range(1, n // 2):
        tau = 0.5 + np.sum(rho[1 : w + 1])
        tau_w = max(tau, 1e-10)
        # S/tau relation inverted for the exponential window estimate
        tau_exp = max(s_tau * tau_w, 1e-10)
        g = np.exp(-w / tau_exp) - tau_w / np.sqrt(w * n)
        if g < 0:
            w_opt = w
            break
    tau_int = float(max(0.5 + np.sum(rho[1 : w_opt + 1]), 0.5))
    # Wolff bias correction (hep-lat/0306017 eq. 49 remark: Gamma is
    # biased low by O(tau/N); correct tau_int by (1 + (2W+1)/N))
    tau_int *= 1.0 + (2.0 * w_opt + 1.0) / n
    mean = float(np.mean(v))
    err = float(np.sqrt(2.0 * tau_int * gamma[0] / n))
    return mean, err, tau_int, int(w_opt)


def static_potential(w_rt):
    """V(R) from a Wilson-loop matrix W[R-1, T-1] = <W(R,T)>:
    effective-mass estimate V(R) = ln(W(R,T-1)/W(R,T)) at the largest
    usable T (measure_Wilsonloop analysis convention; the RxT series
    comes straight from Wilson_loop.txt via read_wilson_loop)."""
    w = np.asarray(w_rt, dtype=np.float64)
    rmax, tmax = w.shape
    v = np.full(rmax, np.nan)
    for r in range(rmax):
        ok = w[r] > 0
        t = tmax - 1
        while t >= 1 and not (ok[t] and ok[t - 1]):
            t -= 1
        if t >= 1:
            v[r] = np.log(w[r, t - 1] / w[r, t])
    return v


def creutz_ratio(w_rt, r: int, t: int):
    """chi(R,T) = -ln[ W(R,T) W(R-1,T-1) / (W(R,T-1) W(R-1,T)) ]:
    the standard string-tension estimator (perimeter/corner terms
    cancel; -> sigma a^2 for large R,T, and -> -ln u(beta) at strong
    coupling). r, t are 1-based loop extents (r,t >= 2)."""
    w = np.asarray(w_rt, dtype=np.float64)
    # r/t < 2 would wrap the r-2/t-2 indices to -1 (Python negative
    # indexing) and silently build the ratio from the largest loops.
    if r < 2 or t < 2 or r > w.shape[0] or t > w.shape[1]:
        return float("nan")
    num = w[r - 1, t - 1] * w[r - 2, t - 2]
    den = w[r - 1, t - 2] * w[r - 2, t - 1]
    if num <= 0 or den <= 0:
        return float("nan")
    return float(-np.log(num / den))


def read_wilson_loop(filename):
    """Wilson_loop.txt -> dict itrj -> W[R-1, T-1] matrix.

    WilsonLoopMeasurement writes `{itrj} {additional_string}{r} {t} {w}`
    (scheduler.py:142), and additional_string may hold extra fields
    (e.g. flow `{itrj} {istep} {tau} `, lqcd.py:231) — so r, t, w are
    parsed as the LAST three fields before the comment, not columns
    1-3 (ADVICE r3)."""
    out = {}
    with open(filename) as fp:
        for line in fp:
            parts = line.split("#")[0].split()
            if len(parts) < 4:
                continue
            try:
                itrj = int(float(parts[0]))
                r, t, w = int(parts[-3]), int(parts[-2]), float(parts[-1])
            except ValueError:
                continue
            if r < 1 or t < 1:
                continue
            out.setdefault(itrj, {})[(r, t)] = w
    mats = {}
    for itrj, d in out.items():
        rmax = max(k[0] for k in d)
        tmax = max(k[1] for k in d)
        m = np.full((rmax, tmax), np.nan)
        for (r, t), w in d.items():
            m[r - 1, t - 1] = w
        mats[itrj] = m
    return mats


def read_flow_series(filename):
    """Flowed measurement file -> (taus, mean-over-trajectories values).

    The driver writes flowed lines as `{itrj} {itrj} {istep} {tau}
    {value} # name` (lqcd.py flowed-measurement loop: additional_string
    = "{itrj} {istep} {tau} ", prepended by the measurement's own
    itrj). tau and value are parsed as fields [-2]/[-1] before the
    comment so the format stays robust to extra leading fields, the
    same right-anchored convention as read_wilson_loop. Returns
    (taus[ntau], values[ntau]) with values averaged over all
    trajectories at fixed tau, taus sorted ascending."""
    acc = {}
    with open(filename) as fp:
        for line in fp:
            parts = line.split("#")[0].split()
            if len(parts) < 4:
                continue
            try:
                tau, val = float(parts[-2]), float(parts[-1])
            except ValueError:
                continue
            acc.setdefault(tau, []).append(val)
    taus = np.asarray(sorted(acc))
    vals = np.asarray([np.mean(acc[t]) for t in taus])
    return taus, vals


def t0_scale(taus, e, target: float = 0.3):
    """Gradient-flow scale t0: the flow time where t^2 E(t) = target.

    Lüscher's scale setting (arXiv:1006.4518 eq. 2.4): t^2 <E(t)> is
    monotonically rising along the flow and crosses `target` (0.3 by
    convention) at t = t0; a^2/t0 then sets the lattice spacing.
    Linear interpolation between the two bracketing flow times.
    NOTE on normalization: E here is whatever the caller measured.
    The driver's `Energy_density` follows the reference convention
    (measure_energy_density.jl:93-133, observables.energy_density),
    which differs from the continuum E = G^a_{mu nu} G^a_{mu nu} / 4
    by a constant factor; for literature-comparable t0 rescale E (or
    the target) accordingly. Returns NaN when t^2 E never reaches
    `target` inside the measured flow window."""
    taus = np.asarray(taus, dtype=np.float64)
    y = taus**2 * np.asarray(e, dtype=np.float64)
    return _first_crossing(taus, y, target)


def w0_scale(taus, e, target: float = 0.3):
    """Gradient-flow scale w0: sqrt(t*) where W(t) = t d/dt [t^2 E(t)]
    crosses `target` (BMW collaboration, arXiv:1203.4469 eq. 3-4).
    W is built from centered differences of the measured t^2 E series
    (one-sided at the ends), so at least 3 flow times are required;
    the derivative-based definition cancels the multiplicative-
    normalization sensitivity that t0 carries. Returns NaN when W
    never reaches `target` in the window."""
    taus = np.asarray(taus, dtype=np.float64)
    y = taus**2 * np.asarray(e, dtype=np.float64)
    if len(taus) < 3:
        return float("nan")
    w = taus * np.gradient(y, taus)
    tstar = _first_crossing(taus, w, target)
    return float(np.sqrt(tstar)) if np.isfinite(tstar) else float("nan")


def effective_mass(corr, periodic: bool = True, tol: float = 1e-12):
    """Per-timeslice effective mass from a correlator series C(t).

    periodic=False: the naive m_eff(t) = ln[C(t)/C(t+1)] (valid far
    from the boundary). periodic=True (default): solves the
    finite-T cosh ratio C(t)/C(t+1) = cosh(m(t-T/2))/cosh(m(t+1-T/2))
    per t by bisection — the standard correction for the backward-
    propagating image on a periodic/antiperiodic lattice, which the
    naive log systematically underestimates near t ~ T/2 (where the
    pion_correlator measurement actually has its best signal).
    Returns an array of length T-1 with NaN where the ratio is
    unusable (non-positive entries, or t = T/2 where the cosh ratio
    carries no mass information)."""
    c = np.asarray(corr, dtype=np.float64)
    t_ext = len(c)
    out = np.full(t_ext - 1, np.nan)
    for t in range(t_ext - 1):
        if c[t] <= 0 or c[t + 1] <= 0:
            continue
        ratio = c[t] / c[t + 1]
        if not periodic:
            if ratio > 0:
                out[t] = np.log(ratio)
            continue
        x0 = t - t_ext / 2.0
        x1 = t + 1 - t_ext / 2.0

        def logcosh(z):
            z = abs(z)  # log cosh z, overflow-free for large z
            return z + np.log1p(np.exp(-2.0 * z)) - np.log(2.0)

        f = lambda m: logcosh(m * x0) - logcosh(m * x1) - np.log(ratio)  # noqa: E731
        # cosh ratio is monotone in m on each side of T/2; bracket up
        lo, hi = 0.0, 1.0
        if abs(f(lo)) < tol:
            out[t] = 0.0
            continue
        sign0 = np.sign(f(lo))
        while np.sign(f(hi)) == sign0 and hi < 1e3:
            hi *= 2.0
        if np.sign(f(hi)) == sign0:
            continue  # no crossing: e.g. t exactly at T/2 (ratio=1/1)
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if np.sign(f(mid)) == sign0:
                lo = mid
            else:
                hi = mid
            if hi - lo < tol:
                break
        out[t] = 0.5 * (lo + hi)
    return out


def _first_crossing(x, y, target):
    """First upward linear-interpolated crossing of y(x) = target."""
    for i in range(1, len(x)):
        if (y[i - 1] < target) and (y[i] >= target):
            f = (target - y[i - 1]) / (y[i] - y[i - 1])
            return float(x[i - 1] + f * (x[i] - x[i - 1]))
    return float("nan")


def main(argv=None):
    """CLI: python -m latticeqcd_torch.analysis <measuredir> [skip]

    Prints mean +- jackknife error for every measurement series in the
    directory (the reference's analysis_sample.jl workflow,
    src/analyze.jl counterpart).
    """
    import os
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m latticeqcd_torch.analysis <measuredir> [skip]")
        return 2
    measuredir = argv[0]
    skip = int(argv[1]) if len(argv) > 1 else 0
    for fn in sorted(os.listdir(measuredir)):
        if not fn.endswith(".txt"):
            continue
        path = os.path.join(measuredir, fn)
        if "Pion_correlator" in fn:
            # lines: "{itrj} c(0) ... c(T-1) " + a separate
            # "#pioncorrelator" comment line (scheduler.py); average
            # the correlator over trajectories, quote the cosh
            # effective mass at the cleanest timeslice (T/4).
            corrs = []
            with open(path) as fp:
                for line in fp:
                    parts = line.split("#")[0].split()
                    if len(parts) >= 3:
                        corrs.append([float(x) for x in parts[1:]])
            if corrs:
                c = np.mean(np.asarray(corrs), axis=0)
                me = effective_mass(c)
                t_quote = max(1, len(c) // 4)
                print(f"{fn:32s} m_eff(t={t_quote})={me[t_quote]:.5f}  "
                      f"(cosh, {len(corrs)} configs, T={len(c)})")
                continue
        if "Energy_density" in fn and "_flow" in fn:
            taus, evals = read_flow_series(path)
            if len(taus) >= 2:
                t0 = t0_scale(taus, evals)
                w0 = w0_scale(taus, evals)
                print(f"{fn:32s} t0/a^2={t0:.5f} w0/a={w0:.5f}  "
                      f"(ntau={len(taus)}, reference-convention E)")
                continue
        itrj, vals = read_measurement_series(path)
        if len(itrj) <= skip:
            print(f"{fn:32s} ({len(itrj)} rows, skipped)")
            continue
        v = vals[skip:, 0]
        if len(v) >= 20:
            mean, err = jackknife(v)
            _, _, tau, _ = autocorrelation(v)
            print(f"{fn:32s} {mean:+.8f} +- {err:.8f}  (n={len(v)}, tau_int={tau:.2f})")
        else:
            print(f"{fn:32s} {float(np.mean(v)):+.8f} +- {float(np.std(v)):.8f}  (n={len(v)}, naive)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
