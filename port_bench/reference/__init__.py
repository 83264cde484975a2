"""Plain PyTorch references of the benchmark's configurations.

They import nothing of the port (nor JAX): each re-derives from the weights
and inputs the benchmark made what the port's timed path must produce, so
``correct`` holds the port to them. Products take their inputs rounded to
the configuration's precision (``common.rounding``) and sum in float32,
with TF32 off; the control rounds to fp8 instead.
"""
