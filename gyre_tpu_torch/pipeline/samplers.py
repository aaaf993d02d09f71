"""Samplers over a sigma-space denoiser, as Python loops on torch tensors.

Counterpart of gyre_tpu/pipeline/samplers.py, same calling convention:

    sample(name, denoise, x, sigmas, noise_fn, params,
           start=0, steps=None, carry=None, return_carry=False)

``denoise(x, sigma) -> x0`` is the CFG-wrapped model, ``sigmas`` the full
descending request ramp (host floats, last 0), ``noise_fn(i, tag)`` the
per-sample noise of stream ``tag`` at GLOBAL step ``i``, ``start``/``steps``
a window of global step indices and ``carry`` the sampler's cross-step
state, so a chunked run (progress, cancellation) computes exactly what one
run does, for every sampler.

Step arithmetic runs on the host in Python floats, so where the JAX
package selects a branch with ``lax.cond``/``jnp.where`` the port runs only
the branch taken: the model is called only where the update needs it
(heun's and dpm_2's second call not on the last step, the ancestral
midpoint only where sigma_down > 0, the SDE stages only where
sigma_next > 0), and noise is drawn only where it is added with a nonzero
scale. dpm_adaptive keeps its step control in float32, as the JAX package
does, so its accept/reject decisions are the same.

The algorithms are the published ones (Song et al. DDIM; Ho et al. DDPM;
Karras et al. 2022 Algorithm 2 for euler/heun/dpm-2 + churn; Lu et al.
DPM-Solver / DPM-Solver++).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplerParams:
    """The request's sampler knobs."""

    eta: float = 1.0            # ancestral/DDIM eta
    churn: float = 0.0          # Karras s_churn
    churn_tmin: float = 0.0
    churn_tmax: float = 0.0     # <= 0 means unbounded
    warmup_lms: bool = False    # dpm++ 2m: midpoint warmup on the first step
    ddim_cutoff: float = 0.0    # dpm++ 2m: first-order fallback below this


# ----------------------------------------------------------------- helpers


def _t(sigma: float) -> float:
    return -math.log(max(sigma, 1e-10))


def _window(sigmas, start, steps):
    """(n, the global step indices of this segment)."""
    n = len(sigmas) - 1
    steps = n if steps is None else steps
    return n, range(start, start + steps)


def _ancestral_steps(sigma: float, sigma_next: float, eta: float):
    """(sigma_down, sigma_up) for ancestral samplers."""
    su = min(sigma_next, eta * math.sqrt(max(
        sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
        / max(sigma ** 2, 1e-20), 0.0)))
    sd = math.sqrt(max(sigma_next ** 2 - su ** 2, 0.0))
    return sd, su


def _gamma(sigma: float, n_steps: int, p: SamplerParams) -> float:
    """Karras churn gamma. n_steps is the FULL ramp's step count, so churn
    strength does not depend on chunk boundaries."""
    tmax = p.churn_tmax if p.churn_tmax > 0 else math.inf
    if p.churn_tmin <= sigma <= tmax:
        return min(p.churn / n_steps, math.sqrt(2.0) - 1.0)
    return 0.0


def _churn(x, sigma, i, n, p, noise_fn):
    """(x raised to sigma_hat, sigma_hat) for the churn samplers."""
    gamma = _gamma(sigma, n, p)
    sigma_hat = sigma * (1 + gamma)
    if gamma > 0:
        x = x + noise_fn(i, "churn") * math.sqrt(
            max(sigma_hat ** 2 - sigma ** 2, 0.0))
    return x, sigma_hat


def _add_noise(x, noise_fn, i, tag, scale):
    """x + noise * scale; a zero scale adds exactly nothing, so it draws
    nothing."""
    return x + noise_fn(i, tag) * scale if scale > 0 else x


# ---------------------------------------------------------------- samplers


def sample_euler(denoise, x, sigmas, noise_fn, p: SamplerParams,
                 start=0, steps=None, carry=None, return_carry=False):
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x, sigma_hat = _churn(x, sigma, i, n, p, noise_fn)
        x0 = denoise(x, sigma_hat)
        d = (x - x0) / sigma_hat
        x = x + d * (sigma_next - sigma_hat)
    return (x, ()) if return_carry else x


def sample_euler_ancestral(denoise, x, sigmas, noise_fn, p: SamplerParams,
                           start=0, steps=None, carry=None,
                           return_carry=False):
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        sd, su = _ancestral_steps(sigma, sigma_next, p.eta)
        d = (x - x0) / sigma
        x = x + d * (sd - sigma)
        x = _add_noise(x, noise_fn, i, "anc", su)
    return (x, ()) if return_carry else x


def sample_heun(denoise, x, sigmas, noise_fn, p: SamplerParams,
                start=0, steps=None, carry=None, return_carry=False):
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x, sigma_hat = _churn(x, sigma, i, n, p, noise_fn)
        x0 = denoise(x, sigma_hat)
        d = (x - x0) / sigma_hat
        dt = sigma_next - sigma_hat
        x_euler = x + d * dt
        if sigma_next > 0:
            sn = max(sigma_next, 1e-8)
            d2 = (x_euler - denoise(x_euler, sn)) / sn
            x = x + (d + d2) * 0.5 * dt
        else:
            x = x_euler
    return (x, ()) if return_carry else x


def sample_dpm_2(denoise, x, sigmas, noise_fn, p: SamplerParams,
                 start=0, steps=None, carry=None, return_carry=False):
    """Karras DPM-2: midpoint method in sigma^(1/3) space."""
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x, sigma_hat = _churn(x, sigma, i, n, p, noise_fn)
        x0 = denoise(x, sigma_hat)
        d = (x - x0) / sigma_hat
        if sigma_next > 0:
            sn = max(sigma_next, 1e-8)
            sigma_mid = math.exp(0.5 * (math.log(sigma_hat) + math.log(sn)))
            x_2 = x + d * (sigma_mid - sigma_hat)
            d2 = (x_2 - denoise(x_2, sigma_mid)) / sigma_mid
            x = x + d2 * (sigma_next - sigma_hat)
        else:
            x = x + d * (sigma_next - sigma_hat)
    return (x, ()) if return_carry else x


def sample_dpm_2_ancestral(denoise, x, sigmas, noise_fn, p: SamplerParams,
                           start=0, steps=None, carry=None,
                           return_carry=False):
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        sd, su = _ancestral_steps(sigma, sigma_next, p.eta)
        d = (x - x0) / sigma
        if sd > 0:
            sdn = max(sd, 1e-8)
            sigma_mid = math.exp(0.5 * (math.log(sigma) + math.log(sdn)))
            x_2 = x + d * (sigma_mid - sigma)
            d2 = (x_2 - denoise(x_2, sigma_mid)) / sigma_mid
            x = x + d2 * (sd - sigma)
        else:
            x = x + d * (sd - sigma)
        x = _add_noise(x, noise_fn, i, "anc", su)
    return (x, ()) if return_carry else x


def _lms_coefficients(sigmas, order: int = 4) -> np.ndarray:
    """Adams-Bashforth coefficients over the sigma grid, integrated
    numerically on the host in float64 (data-independent). [n, order]."""
    try:
        trapezoid = np.trapezoid
    except AttributeError:      # numpy < 2
        trapezoid = np.trapz
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    coeffs = np.zeros((n, order))
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            # integrate the Lagrange basis poly over [sigma_i, sigma_{i+1}]
            ts = np.linspace(sig[i], sig[i + 1], 128)
            prod = np.ones_like(ts)
            for k in range(cur_order):
                if k == j:
                    continue
                prod *= (ts - sig[i - k]) / (sig[i - j] - sig[i - k])
            coeffs[i, j] = trapezoid(prod, ts)
    return coeffs


def _combine(coeffs, history):
    """sum_j coeffs[j] * history[j] over the history there is (newest
    first); missing entries are the JAX package's zero rows."""
    out = None
    for c, h in zip(coeffs, history):
        out = h * float(c) if out is None else out + h * float(c)
    return out


def sample_lms(denoise, x, sigmas, noise_fn, p: SamplerParams,
               start=0, steps=None, carry=None, return_carry=False, *,
               order: int = 4):
    """Linear multistep; the carry is the derivative history, newest
    first (at most ``order`` entries)."""
    n, idx = _window(sigmas, start, steps)
    coeffs = _lms_coefficients(sigmas, order)
    ds = tuple(carry[0]) if carry else ()
    for i in idx:
        sigma = float(sigmas[i])
        d = (x - denoise(x, sigma)) / sigma
        ds = ((d,) + ds)[:order]
        x = x + _combine(coeffs[i][:min(i + 1, order)], ds)
    return (x, (ds,)) if return_carry else x


_PLMS_COMBOS = ((1.0,), (3 / 2, -1 / 2), (23 / 12, -16 / 12, 5 / 12),
                (55 / 24, -59 / 24, 37 / 24, -9 / 24))


def sample_plms(denoise, x, sigmas, noise_fn, p: SamplerParams,
                start=0, steps=None, carry=None, return_carry=False, *,
                order: int = 4, first: bool | None = None):
    """PLMS (PNDM with skip_prk_steps) in sigma space: the update
    x' = x - (sigma_i - sigma_{i+1}) * eps_eff with an Adams-Bashforth
    combination of past eps predictions, of order 1/2/3/4 as history
    builds up. The carry is the eps history, newest first.

    The first step is diffusers' duplicate-timestep corrector: an Euler
    predictor to sigma_1, a second eps evaluation there and a trapezoid
    re-step from the original x, with only the predictor's eps entering
    the history. ``first`` marks the segment that holds global step 0;
    by default it is ``start == 0``, so a chunked run takes the corrector
    exactly where one run does. (The JAX package's chunked path marks no
    segment first and skips it; the port holds to its single scan.)"""
    if first is None:
        first = start == 0
    n, idx = _window(sigmas, start, steps)
    ets = tuple(carry[0]) if carry else ()
    if first and len(idx):
        s0, s1 = float(sigmas[0]), float(sigmas[1])
        e0 = (x - denoise(x, s0)) / s0
        x_pred = x - (s0 - s1) * e0                    # Euler predictor
        e1 = (x_pred - denoise(x_pred, s1)) / s1
        x = x - (s0 - s1) * 0.5 * (e0 + e1)            # trapezoid corrector
        ets = (e0,)
        idx = idx[1:]
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        e = (x - denoise(x, sigma)) / sigma
        ets = ((e,) + ets)[:order]
        x = x - (sigma - sigma_next) * _combine(
            _PLMS_COMBOS[min(i, order - 1)], ets)
    return (x, (ets,)) if return_carry else x


def sample_dpmpp_2s_ancestral(denoise, x, sigmas, noise_fn, p: SamplerParams,
                              start=0, steps=None, carry=None,
                              return_carry=False):
    """DPM-Solver++(2S) with ancestral noise."""
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        sd, su = _ancestral_steps(sigma, sigma_next, p.eta)
        if sd > 0:
            t, t_next = _t(sigma), _t(sd)
            h = t_next - t
            s_mid = t + h * 0.5
            x_2 = (math.exp(-s_mid) / math.exp(-t)) * x \
                - math.expm1(-h * 0.5) * x0
            x0_2 = denoise(x_2, math.exp(-s_mid))
            x = (math.exp(-t_next) / math.exp(-t)) * x \
                - math.expm1(-h) * x0_2
        else:
            x = x0
        x = _add_noise(x, noise_fn, i, "anc", su)
    return (x, ()) if return_carry else x


def sample_dpmpp_2m(denoise, x, sigmas, noise_fn, p: SamplerParams,
                    start=0, steps=None, carry=None, return_carry=False):
    """DPM-Solver++(2M): second-order multistep, one model call per step.
    The previous step's x0 is the carry."""
    n, idx = _window(sigmas, start, steps)
    x0_prev = carry[0] if carry else torch.zeros_like(x)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        if sigma_next <= 0:
            x = x0
        else:
            t, t_next = _t(sigma), _t(sigma_next)
            h = t_next - t
            ratio = sigma_next / sigma
            if i > 0 and sigma_next > p.ddim_cutoff:
                r = (t - _t(float(sigmas[i - 1]))) / h
                x0_d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * x0_prev
                x = ratio * x - math.expm1(-h) * x0_d
            elif p.warmup_lms and i == 0:
                # LMS warmup: a midpoint model evaluation replaces the
                # first-order first step
                s_mid = t + 0.5 * h
                sig_mid = math.exp(-s_mid)
                x_2 = (sig_mid / sigma) * x - math.expm1(-h * 0.5) * x0
                x = ratio * x - math.expm1(-h) * denoise(x_2, sig_mid)
            else:
                x = ratio * x - math.expm1(-h) * x0
        x0_prev = x0
    return (x, (x0_prev,)) if return_carry else x


def sample_dpmpp_sde(denoise, x, sigmas, noise_fn, p: SamplerParams,
                     start=0, steps=None, carry=None, return_carry=False):
    """DPM-Solver++ (stochastic), r=1/2 two-stage; noise streams sde1 and
    sde2."""
    n, idx = _window(sigmas, start, steps)
    r = 0.5
    fac = 1.0 / (2.0 * r)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        if sigma_next <= 0:
            x = x0
            continue
        t, t_next = _t(sigma), _t(sigma_next)
        h = t_next - t
        s = t + h * r
        # stage 1
        sd1, su1 = _ancestral_steps(math.exp(-t), math.exp(-s), p.eta)
        s_1 = _t(sd1)
        x_2 = (math.exp(-s_1) / math.exp(-t)) * x - math.expm1(t - s_1) * x0
        x_2 = _add_noise(x_2, noise_fn, i, "sde1", su1)
        x0_2 = denoise(x_2, math.exp(-s))
        # stage 2
        sd2, su2 = _ancestral_steps(math.exp(-t), math.exp(-t_next), p.eta)
        t_2 = _t(sd2)
        x0_d = (1 - fac) * x0 + fac * x0_2
        x = (math.exp(-t_2) / math.exp(-t)) * x - math.expm1(t - t_2) * x0_d
        x = _add_noise(x, noise_fn, i, "sde2", su2)
    return (x, ()) if return_carry else x


def sample_dpmpp_3m(denoise, x, sigmas, noise_fn, p: SamplerParams,
                    start=0, steps=None, carry=None, return_carry=False):
    """DPM-Solver++ third-order multistep (proto DPMSOLVERPP_3ORDER). The
    carry is the two previous x0 and step sizes."""
    n, idx = _window(sigmas, start, steps)
    if carry:
        x0_1, x0_2, h_1, h_2 = carry
    else:
        x0_1, x0_2, h_1, h_2 = torch.zeros_like(x), torch.zeros_like(x), \
            1.0, 1.0
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        h = _t(sigma_next) - _t(sigma)
        if sigma_next <= 0:
            x_next = x0
        else:
            x_next = (sigma_next / sigma) * x - math.expm1(-h) * x0
            if i >= 1:
                r1 = h_1 / h
                d1_0 = (x0 - x0_1) / r1
                phi2 = math.expm1(-h) / h + 1.0
                if i >= 2:
                    r2 = h_2 / h
                    d1_1 = (x0_1 - x0_2) / r2
                    d1 = d1_0 + (d1_0 - d1_1) * (r1 / (r1 + r2))
                    d2 = (d1_0 - d1_1) / (r1 + r2)
                    phi3 = phi2 / h - 0.5
                    x_next = x_next + phi2 * d1 - phi3 * d2
                else:
                    x_next = x_next + phi2 * d1_0
        x, x0_1, x0_2, h_1, h_2 = x_next, x0, x0_1, h, h_1
    return (x, (x0_1, x0_2, h_1, h_2)) if return_carry else x


def sample_ddim(denoise, x, sigmas, noise_fn, p: SamplerParams,
                start=0, steps=None, carry=None, return_carry=False):
    """DDIM in sigma space: x = x0 + sigma_down * eps + sigma_up * noise
    with the ancestral split, i.e. DDIM(eta) is euler-ancestral(eta) on
    the continuous schedule; eta=0 is the deterministic step."""
    n, idx = _window(sigmas, start, steps)
    for i in idx:
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        eps = (x - x0) / sigma
        sd, su = _ancestral_steps(sigma, sigma_next, p.eta)
        x = _add_noise(x0 + sd * eps, noise_fn, i, "ddim", su)
    return (x, ()) if return_carry else x


def sample_ddpm(denoise, x, sigmas, noise_fn, p: SamplerParams,
                start=0, steps=None, carry=None, return_carry=False):
    """DDPM ancestral sampling = euler-ancestral with eta=1."""
    return sample_euler_ancestral(
        denoise, x, sigmas, noise_fn,
        SamplerParams(eta=1.0, churn=p.churn, churn_tmin=p.churn_tmin,
                      churn_tmax=p.churn_tmax),
        start=start, steps=steps, carry=carry, return_carry=return_carry)


def sample_dpm_fast(denoise, x, sigmas, noise_fn, p: SamplerParams,
                    start=0, steps=None, carry=None, return_carry=False):
    """k-diffusion ``sample_dpm_fast``: singlestep DPM-Solver over a
    uniform grid in t = -log(sigma), split into m = n//3 + 1 segments of
    order 3 except the tail ([3]*(m-2)+[2,1] when n%3 == 0, else
    [3]*(m-1)+[n%3]). One model call per global step index: the segment,
    sub-step and order follow from the index, and the segment-start latent
    and its cached eps ride the carry (x_seg, eps0, eps_r1), so a chunk
    boundary may fall inside a segment. The result is x at sigma_min (no
    final denoise). p.eta applies k-diffusion's ancestral variant."""
    n, idx = _window(sigmas, start, steps)
    t_start = -math.log(float(sigmas[0]))
    t_end = -math.log(max(float(sigmas[n - 1]), 1e-5))
    m = n // 3 + 1
    r = n % 3
    n3 = m - 2 if r == 0 else m - 1       # number of order-3 segments

    def t_of(k):
        return t_start + (t_end - t_start) * k / m

    x_seg, eps0, eps_r1 = carry if carry else \
        (x, torch.zeros_like(x), torch.zeros_like(x))
    for i in idx:
        if i < 3 * n3:
            seg, sub, order = i // 3, i % 3, 3
        elif r > 0:
            seg, sub, order = n3, i - 3 * n3, r
        elif i - 3 * n3 < 2:
            seg, sub, order = n3, i - 3 * n3, 2
        else:
            seg, sub, order = n3 + 1, 0, 1
        t, t_next = t_of(seg), t_of(seg + 1)
        if p.eta > 0:
            # ancestral shrink (k-diffusion dpm_solver_fast eta branch)
            sd, _ = _ancestral_steps(math.exp(-t), math.exp(-t_next), p.eta)
            t_next_ = min(t_end, -math.log(max(sd, 1e-10)))
            su = math.sqrt(max(math.exp(-2.0 * t_next)
                               - math.exp(-2.0 * t_next_), 0.0))
        else:
            # exactly no noise: the formula above leaves su of the order
            # of sqrt(rounding) * sigma, as -log(exp(-t)) is not t
            t_next_, su = min(t_end, t_next), 0.0
        h = t_next_ - t
        r1 = 1.0 / 3.0 if order == 3 else 0.5
        r2 = 2.0 / 3.0
        s1 = t + r1 * h
        s2 = t + r2 * h
        # the one model call of this index, at this sub-step's point
        # (x_seg at t, u1 at s1, u2 at s2)
        sigma_pt = math.exp(-(t, s1, s2)[sub])
        eps = (x - denoise(x, sigma_pt)) / sigma_pt
        if sub == 0:
            x_seg, eps0 = x, eps
        elif sub == 1:
            eps_r1 = eps
        st_n = math.exp(-t_next_)
        # k-diffusion dpm_solver_{1,2,3}_step, the candidate this sub-step
        # of this order needs
        if sub == 0 and order > 1:
            x = x_seg - math.exp(-s1) * math.expm1(r1 * h) * eps0     # u1
        elif sub == 1 and order == 3:
            x = x_seg - math.exp(-s2) * math.expm1(r2 * h) * eps0 \
                - math.exp(-s2) * (r2 / r1) * (
                    math.expm1(r2 * h) / (r2 * h) - 1.0) * (eps_r1 - eps0)
        else:
            x = x_seg - st_n * math.expm1(h) * eps0                 # final1
            if sub == 1:
                x = x - st_n / (2.0 * r1) * math.expm1(h) * (eps_r1 - eps0)
            elif sub == 2:
                x = x - st_n / r2 * (math.expm1(h) / h - 1.0) * (eps - eps0)
        if sub == order - 1:
            # ancestral noise once per segment, on its completing call
            x = _add_noise(x, noise_fn, i, "anc", su)
    return (x, (x_seg, eps0, eps_r1)) if return_carry else x


ADAPTIVE_MAX_STEPS = 128


def sample_dpm_adaptive(denoise, x, sigmas, noise_fn, p: SamplerParams,
                        start=0, steps=None, carry=None, return_carry=False,
                        *, rtol: float = 0.05, atol: float = 0.0078,
                        max_steps: int = ADAPTIVE_MAX_STEPS):
    """Adaptive DPM-Solver-12 with PI step-size control between sigmas[0]
    and the ramp's sigma_min, then a final denoise to x0.

    t, h and the error norm are float32, as in the JAX package, so the
    accept decisions (err <= 1) match; each iteration reads err back to
    the host once (the decision and the loop condition need it). With a
    carry (has_state, t, h, step, finished), ``steps`` bounds the
    iterations of this segment and the dispatcher's loop goes on until
    the carried ``finished`` is set; the final denoise applies exactly
    once, in the segment where the solver reaches sigma_min. Without a
    carry the call runs to the end. The error norm is a mean over the
    whole batch, so adaptive requests never coalesce."""
    f32 = np.float32
    t_start = -np.log(f32(sigmas[0]))
    t_end = -np.log(max(f32(sigmas[-2]), f32(1e-3)))
    if carry and carry[0]:
        _, t, h, step, finished0 = carry
    else:
        t, h, step, finished0 = t_start, (t_end - t_start) / f32(16.0), 0, 0
    seg_cap = int(steps or max_steps) if carry else max_steps
    it = 0
    while t < t_end and step < max_steps and it < seg_cap:
        h = min(h, t_end - t)
        s0 = np.exp(-t)
        s1 = np.exp(-(t + h))
        s_mid = np.exp(-(t + h / f32(2.0)))
        x0 = denoise(x, float(s0))
        # order-1 (DPM-Solver-1) proposal and the order-2 midpoint one
        x_1 = float(s1 / s0) * x - float(np.expm1(-h)) * x0
        u = float(s_mid / s0) * x - float(np.expm1(-h / f32(2.0))) * x0
        x_2 = float(s1 / s0) * x - float(np.expm1(-h)) * denoise(
            u, float(s_mid))
        tol = atol + rtol * torch.maximum(x_1.abs(), x_2.abs())
        err = f32(torch.sqrt(torch.mean(((x_2 - x_1) / tol) ** 2)).item())
        if err <= 1.0:
            x, t = x_2, t + h
        with np.errstate(divide="ignore"):
            h = h * np.clip(f32(0.9) * err ** f32(-0.5), f32(0.2), f32(5.0))
        step += 1
        it += 1
    done_now = bool(t >= t_end or step >= max_steps)
    if done_now and not finished0:
        x = denoise(x, float(np.exp(-t_end)))
    if not return_carry:
        return x
    return x, (1, t, h, step, int(finished0 or done_now))


# ------------------------------------------------------------------ registry

SAMPLERS = {
    "ddim": sample_ddim,
    "ddpm": sample_ddpm,
    "plms": sample_plms,
    "k_euler": sample_euler,
    "k_euler_ancestral": sample_euler_ancestral,
    "k_heun": sample_heun,
    "k_dpm_2": sample_dpm_2,
    "k_dpm_2_ancestral": sample_dpm_2_ancestral,
    "k_lms": sample_lms,
    "k_dpmpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "k_dpmpp_2m": sample_dpmpp_2m,
    "k_dpmpp_sde": sample_dpmpp_sde,
    "dpmsolverpp_1order": sample_euler,  # 1st-order dpm++ == ODE euler
    "dpmsolverpp_2order": sample_dpmpp_2m,
    "dpmsolverpp_3order": sample_dpmpp_3m,
    "dpm_fast": sample_dpm_fast,
    "dpm_adaptive": sample_dpm_adaptive,
    "dpmsolverpp_2s_ancestral": sample_dpmpp_2s_ancestral,
    "dpmsolverpp_sde": sample_dpmpp_sde,
    "dpmsolverpp_2m": sample_dpmpp_2m,
}

# every sampler runs in segments with exact state carry; dpm_adaptive's
# segments bound its solver iterations
CHUNKABLE_SAMPLERS = frozenset(SAMPLERS)

# names the reference runs on the diffusers integer "leading" grid
DIFFUSERS_GRID_SAMPLERS = frozenset({
    "ddim", "ddpm", "plms", "dpmsolverpp_1order", "dpmsolverpp_2order",
    "dpmsolverpp_3order"})

# proto enum value -> sampler name (generation_pb2.DiffusionSampler); enum
# 1 (SAMPLER_DDPM) serves PLMS, as the reference does; ancestral DDPM is
# the sampler name "ddpm"
PROTO_SAMPLERS = {
    0: "ddim", 1: "plms", 2: "k_euler", 3: "k_euler_ancestral", 4: "k_heun",
    5: "k_dpm_2", 6: "k_dpm_2_ancestral", 7: "k_lms",
    8: "k_dpmpp_2s_ancestral", 9: "k_dpmpp_2m", 10: "k_dpmpp_sde",
    500: "dpmsolverpp_1order", 501: "dpmsolverpp_2order",
    502: "dpmsolverpp_3order", 550: "dpm_fast", 551: "dpm_adaptive",
    552: "dpmsolverpp_2s_ancestral", 553: "dpmsolverpp_sde",
    554: "dpmsolverpp_2m",
}

# capability metadata for the engines API
SAMPLER_PROPERTIES = {
    name: {
        "supports_eta": name in ("ddim", "k_euler_ancestral",
                                 "k_dpm_2_ancestral", "k_dpmpp_2s_ancestral",
                                 "k_dpmpp_sde", "dpmsolverpp_2s_ancestral",
                                 "dpmsolverpp_sde"),
        "supports_churn": name in ("k_euler", "k_heun", "k_dpm_2"),
        "supports_sigma_limits": name.startswith(("k_", "dpm")),
        "supports_karras_rho": name.startswith(("k_", "dpm")),
        "supported_noise_types": ["normal", "brownian"]
        if "sde" in name else ["normal"],
    }
    for name in SAMPLERS
}


def _lookup(name: str):
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}")
    return SAMPLERS[name]


def init_carry(name: str, x) -> tuple:
    """Cross-step state of ``name`` before its first step, for latents x."""
    fn = _lookup(name)
    if fn is sample_dpm_fast:
        return (x, torch.zeros_like(x), torch.zeros_like(x))
    if fn is sample_dpmpp_2m:
        return (torch.zeros_like(x),)
    if fn is sample_dpmpp_3m:
        return (torch.zeros_like(x), torch.zeros_like(x), 1.0, 1.0)
    if fn in (sample_lms, sample_plms):
        return ((),)                      # no history yet
    if fn is sample_dpm_adaptive:
        return (0, 0.0, 0.0, 0, 0)        # has_state 0: start from the ramp
    return ()


def sample(name: str, denoise, x, sigmas, noise_fn,
           p: SamplerParams | None = None, *, start=0, steps=None,
           carry=None, return_carry=False, first: bool | None = None):
    """Run sampler ``name``. ``first`` marks the segment holding global
    step 0 for PLMS's corrector (default: ``start == 0``)."""
    fn = _lookup(name)
    kw = {"first": first} if fn is sample_plms else {}
    return fn(denoise, x, sigmas, noise_fn, p or SamplerParams(),
              start=start, steps=steps, carry=carry,
              return_carry=return_carry, **kw)
