"""The likelihood calls of the two VB fits of one analysis, from the ADVI
iterations it returned (`attrs["vb_iterations"]`) and the fit's own
constants (reference R/utilities.R:1487-1494, Stan's ADVI defaults): per
pass, one gradient call with one draw per iteration, and a 100-draw ELBO
without gradients every 100 iterations."""

GRAD_SAMPLES, ELBO_SAMPLES, EVAL_EVERY = 1, 100, 100


def summary(result) -> dict:
    """What the count needs of identify_outliers's result."""
    return {"vb_iterations": [int(i) for i in result.attrs.get("vb_iterations", ())]}


def calls(summary: dict, shape: dict) -> list[tuple[int, bool, int]]:
    out = []
    for iters in summary["vb_iterations"]:
        out.append((GRAD_SAMPLES, True, iters))
        out.append((ELBO_SAMPLES, False, iters // EVAL_EVERY))
    return out
