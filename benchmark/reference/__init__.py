"""The plain references the benchmark judges the program's answers by.

Plain PyTorch and NumPy. Nothing here imports ``jax``, the JAX package or
anything of ``dpu_operator_tpu_torch``: where the program derives
something from the seed (its weights, its prompt encoder), a frozen copy
here derives it again.
"""
