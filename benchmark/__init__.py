"""The benchmark of the PyTorch and CUDA port (`nsfnet_tpu_torch`).

Run one cell once with `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`; README.md says how the pieces are found by name.
Nothing here imports JAX or the JAX package.
"""
