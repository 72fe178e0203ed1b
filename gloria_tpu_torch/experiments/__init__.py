"""Archived experiments of the port: ops that no model path calls, kept with
their kernels and tests as the record of what was tried (counterparts of
``scripts/experiments/``)."""
