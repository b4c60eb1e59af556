"""Plain PyTorch and NumPy references that decide `correct`.

Nothing here imports the program (`sc2bench_tpu_torch`), the JAX package
or JAX: every function works from the weights and inputs that the
benchmark makes, in float32 with TF32 off unless a caller asks for the
lower-precision control.
"""
