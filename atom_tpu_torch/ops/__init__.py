"""Serving ops and kernel wrappers (port of ``atom_tpu/ops``)."""
