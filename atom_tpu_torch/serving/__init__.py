"""Serving model, decode half (port of ``atom_tpu/serving``)."""
