"""The package's own benchmarks (port of ``atom_tpu/benchmarks``):
``bench_kernels`` times the kernels and the glue around them with
``utils/timing.py::bench_op``; ``bench_textgen`` measures decode bursts and
the serving engine across the W4A4, MoE, LoRA and baseline stacks."""
