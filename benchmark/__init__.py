"""The benchmark of ppcseq_tpu_torch: see run.py."""
