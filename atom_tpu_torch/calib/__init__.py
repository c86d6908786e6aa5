"""Calibration of the accuracy pipeline (port of ``atom_tpu/calib``):
saliency and reorder indices, GPTQ, and the pipeline that runs them."""
