"""Chain-count heuristic (reference R/utilities.R:291-303, 1377-1386).

A copy of ppcseq_tpu/infer/chains.py. The chains run in lockstep as one
batch (infer/nuts.py) rather than as forked processes, but the reference's
cost model (fixed 150-iteration warmup per chain vs draws divided across
chains) still decides how many draws each chain contributes, and is
reproduced so draw counts match.
"""

from __future__ import annotations

import math


def find_optimal_number_of_chains(
    how_many_posterior_draws: float, max_number_to_check: int = 100, warmup: int = 150
) -> int:
    """argmin over 2..max of draws/chains + warmup*chains (R/utilities.R:291-303)."""
    best_c, best_cost = 2, float("inf")
    for c in range(2, max_number_to_check + 1):
        cost = how_many_posterior_draws / c + warmup * c
        if cost < best_cost:
            best_cost, best_c = cost, c
    return best_c


def chains_for_run(how_many_posterior_draws: float, cores: int) -> int:
    """Clamp heuristic into [3, cores]-ish as the reference does
    (chains = heuristic %>% min(cores) %>% max(3), R/utilities.R:1377-1381)."""
    return max(3, min(find_optimal_number_of_chains(how_many_posterior_draws), cores))


def mcmc_iterations(how_many_posterior_draws: float, chains: int, warmup: int = 150) -> int:
    """Per-chain post-warmup draws: ceil(draws/chains) (R/utilities.R:1502-1504)."""
    return math.ceil(how_many_posterior_draws / chains)
