"""Parity-critical numeric constants of the reference implementation.

Each constant cites the reference file:line it reproduces (see SURVEY.md §2.3).
"""

# Prior location for lambda_mu (reference R/methods.R:218)
LAMBDA_MU_MU = 5.612671

# Pass-2 overdispersion compensation for fitting on truncated data
# ("Taken by approximation study", reference R/methods.R:339)
TRUNCATION_COMPENSATION_PASS2 = 0.7352941

# Default number of negative-control transcripts (reference R/methods.R:83)
DEFAULT_NEGATIVE_CONTROLS = 500

# Default draws wanted beyond the CI tail (reference R/methods.R:87)
DEFAULT_DRAWS_AFTER_TAIL = 10

# Per-chain fixed warmup cost used by the chain-count heuristic and MCMC launch
# (reference R/utilities.R:297, 1502-1504)
MCMC_WARMUP = 150

# VB (ADVI) settings hard-coded in the reference (R/utilities.R:1487-1494)
VB_MAX_ITER = 50000
VB_TOL_REL_OBJ = 0.005

# Auto-switch to approximated CI analysis above this many required draws
# (reference R/methods.R:171)
APPROX_ANALYSIS_DRAW_THRESHOLD = 20000

# Memory-cost regressions (reference R/methods.R:184-188)
MEM_REGRESSION_MCMC = (1.044e6, 3.777e-2)
MEM_REGRESSION_VB = (1.554e6, 7.327e-2)

# When CI analysis is approximated, only this many actual posterior draws are
# needed from the sampler (reference R/utilities.R:1372)
APPROX_ANALYSIS_PRACTICAL_DRAWS = 1000

# Jittered-HMC (infer/hmc.py) defaults — TPU-tuned, no reference equivalent
# (the reference's chain heuristic, R/utilities.R:291-303, is CPU-process
# economics; on TPU chains are a nearly-free batch dimension). Evidence:
# SWEEP_PIPELINE_r5.json — a sweep at the PIPELINE's own budget (128
# chains x 8 draws, ADVI warm start, both warmups x L in {16,24,32,48}):
# posterior-mean bias of the call-driving block vs a 128x60 w100 L48
# reference fit is at the MC-noise floor for every config with 0
# divergences, so the cheapest wins. warmup 30 matches 60 at this budget
# (the ADVI warm start supplies init + mass; dual averaging only tunes the
# step size), settling the round-4 question of whether the bench-config
# warmup sweep (SWEEP_HMC_r4.json) transferred to the pipeline config.
# bench.py's own 10.5k-draw config (L=48) is evidenced separately there.
HMC_CHAINS = 128
HMC_WARMUP = 30
HMC_LEAPFROG = 16
