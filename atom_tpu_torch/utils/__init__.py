"""Utilities of the accuracy pipeline (port of ``atom_tpu/utils``)."""
