"""Model configs and building blocks (port of ``atom_tpu/models``)."""
