"""The benchmark of the PyTorch and CUDA port (``speech_separation_tpu_torch``).

One command runs one cell once: ``python port_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``. README.md says how the files fit.
"""
