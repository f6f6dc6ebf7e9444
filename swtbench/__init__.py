"""The benchmark of the PyTorch/CUDA port (swiftwatcher_tpu_torch).

`python3 -m swtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once on the card (swtbench/README.md).
"""
