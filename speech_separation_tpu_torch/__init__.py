"""speech_separation_tpu_torch: the PyTorch/CUDA port of speech_separation_tpu.

A second package beside the JAX reference. It imports torch, never JAX, and
nothing of speech_separation_tpu. Its entry points (eval.pipeline,
eval.serve, eval.streaming, train.loop, cli.main) run on a CUDA card unless the caller
passes device="cpu"; the hand-written Hopper kernels live in csrc/ and build with
nvcc at first use (ops/_build.py).
"""
