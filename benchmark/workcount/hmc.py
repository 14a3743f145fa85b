"""The likelihood calls of the two HMC fits of one analysis, from what
each fit returned: its chains (the draws' first axis) and its executed
leapfrog steps over all chains, warmup and draws (`num_leapfrog`), each a
gradient call with one row per chain, plus the gradient at each chain's
start. The ADVI warm start and the rungs of the divergence-retry ladder
before the last leave nothing in the result, so they are not counted."""


def summary(result) -> dict:
    """What the count needs of identify_outliers's result."""
    out = []
    for p in (1, 2):
        fit = result.attrs[f"fit {p}"]
        chains = int(fit.draws.shape[0])
        out.append([chains, int(fit.num_leapfrog) // chains])
    return {"chains_leapfrogs": out}


def calls(summary: dict, shape: dict) -> list[tuple[int, bool, int]]:
    return [(chains, True, leapfrogs + 1) for chains, leapfrogs in summary["chains_leapfrogs"]]
