"""Quantization math (port of ``atom_tpu/quant``)."""
