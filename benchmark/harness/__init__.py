"""The serving benchmark of ``dpu_operator_tpu_torch``.

``run.py`` (one level up) is the entry point. This package holds what the
harness shares between cells: finding a cell's files by name
(``spec``), the one traffic generator (``traffic``), the client-side load
generator that runs in a child process (``loadgen``), the device-trace
reduction (``profile``), the metric readers' loader (``readers``), and one
module per executor kind under ``systems/`` that builds the system under
test from its configuration file and judges its answers against the plain
reference (``benchmark/reference/``).

Nothing here imports ``jax`` or the JAX package.
"""
