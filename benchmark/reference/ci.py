"""Plain reference of the posterior-predictive interval test (reference
R/utilities.R:651-663, 733-784, Stan's neg_binomial_2_log_rng).

The program's credible interval of a cell is an R type-7 quantile of
`n` counts simulated from the posterior predictive: draws of (eta, phi)
resampled from the posterior draws, then NB2 counts. Its value is
random, so it is judged by where it lies in the predictive distribution
the reference works out exactly: the mixture over posterior draws of
NB2(exp(eta), phi), its CDF from the regularized incomplete beta
function. A bound is off when, under that distribution, the order
statistics it sits between could have fallen on its side with a
probability below ALPHA (binomial tails), even after moving the CDF by
Z_ALPHA standard deviations of the posterior sample's own noise (the
program draws its own posterior sample of `n_post` draws).
"""

from __future__ import annotations

import numpy as np
from scipy import special, stats

ALPHA = 1e-9
Z_ALPHA = float(stats.norm.isf(ALPHA / 2))


def nb_cdf(x: np.ndarray, mu: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """P(Y <= x) for Y ~ NB2(mu, phi), broadcast; 0 below 0."""
    x = np.asarray(x, dtype=np.float64)
    p = phi / (phi + mu)
    out = special.betainc(phi, np.maximum(x, 0) + 1.0, p)
    return np.where(x < 0, 0.0, out)


def mixture_cdf(x, mu_draws, phi_draws):
    """(mean, sd over draws) of the NB2 CDF at x[c] per cell c; the draws
    [R, c]."""
    f = nb_cdf(x[None, :], mu_draws, phi_draws)
    return f.mean(axis=0), f.std(axis=0)


def order_ranks(p: float, n: int) -> int:
    """k (1-based): R type-7's quantile at p over n values lies between the
    k-th and the (k+1)-th smallest."""
    return int(np.floor(p * (n - 1))) + 1


def _post_sd(sd, n_post, n_ref):
    return sd * np.sqrt(1.0 / n_post + 1.0 / n_ref) if n_post else sd * np.sqrt(1.0 / n_ref)


def bound_off(b, p, n, mu_draws, phi_draws, n_post):
    """[c] bool: the quantile at level p of n simulated counts reads b[c]
    where its order statistics could not plausibly lie."""
    k = order_ranks(p, n)
    R = mu_draws.shape[0]
    lo, hi = np.floor(b), np.ceil(b) - 1
    f_lo, sd_lo = mixture_cdf(lo, mu_draws, phi_draws)
    f_hi, sd_hi = mixture_cdf(hi, mu_draws, phi_draws)
    f_lo = np.clip(f_lo + Z_ALPHA * _post_sd(sd_lo, n_post, R), 0, 1)
    f_hi = np.clip(f_hi - Z_ALPHA * _post_sd(sd_hi, n_post, R), 0, 1)
    # X_(k) <= b needs at least k counts <= floor(b); X_(k+1) >= b at most
    # k counts <= ceil(b) - 1
    p_lo = stats.binom.sf(k - 1, n, f_lo)
    p_hi = stats.binom.cdf(k, n, f_hi)
    return (p_lo < ALPHA) | (p_hi < ALPHA)


def outside_plausible(y, p, n, mu_draws, phi_draws, n_post):
    """([c] below, [c] above, [c] inside): whether a count y[c] can
    plausibly fall below the interval's lower bound (level p), above its
    upper bound (level 1 - p), or inside it, n simulated counts."""
    R = mu_draws.shape[0]
    k_lo, k_hi = order_ranks(p, n), order_ranks(1 - p, n)
    f_y, sd_y = mixture_cdf(y, mu_draws, phi_draws)
    f_y1, sd_y1 = mixture_cdf(y - 1, mu_draws, phi_draws)
    d_y, d_y1 = Z_ALPHA * _post_sd(sd_y, n_post, R), Z_ALPHA * _post_sd(sd_y1, n_post, R)
    # y < lower needs at most k_lo counts <= y; y > upper at least k_hi
    # counts <= y; y >= lower at least k_lo counts <= y; y <= upper at most
    # k_hi counts <= y - 1
    below = stats.binom.cdf(k_lo, n, np.clip(f_y - d_y, 0, 1)) >= ALPHA
    above = stats.binom.sf(k_hi - 1, n, np.clip(f_y + d_y, 0, 1)) >= ALPHA
    inside = ((stats.binom.sf(k_lo - 1, n, np.clip(f_y + d_y, 0, 1)) >= ALPHA)
              & (stats.binom.cdf(k_hi, n, np.clip(f_y1 - d_y1, 0, 1)) >= ALPHA))
    return below, above, inside
