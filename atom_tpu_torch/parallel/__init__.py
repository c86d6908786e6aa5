"""Parallelism on ``torch.distributed`` (``atom_tpu/parallel``): the rank mesh
and its collectives (``mesh.py``), the accuracy models' DTensor shardings
(``shardings.py``) and the spawner of rank processes (``launch.py``).  The
serving forms (tensor, expert, sequence and data parallel) are in
``serving/parallel.py``, ``serving/moe.py``, ``serving/sp.py`` and
``serving/dp.py``."""
from atom_tpu_torch.parallel.launch import run_ranks
from atom_tpu_torch.parallel.mesh import make_mesh
from atom_tpu_torch.parallel.shardings import (
    data_sharding,
    llama_param_specs,
    mixtral_param_specs,
    opt_param_specs,
    shard_params,
)

__all__ = [
    "make_mesh",
    "run_ranks",
    "data_sharding",
    "llama_param_specs",
    "mixtral_param_specs",
    "opt_param_specs",
    "shard_params",
]
