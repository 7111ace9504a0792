"""The benchmark of dssm_tpu_torch: `python3 benchmark/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>` runs one cell of
BENCHMARK.json once on the card."""
