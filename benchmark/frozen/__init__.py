"""Frozen copies of the program's arithmetic that the benchmark measures with."""
