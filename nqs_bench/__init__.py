"""The benchmark of noisyquantumsimulator_tpu_torch on the NVIDIA H100.

`python3 nqs_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON result line; see
README.md.
"""
