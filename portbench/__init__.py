"""The benchmark of the PyTorch/CUDA port, `vqvaehmm_tpu_torch`, on an
NVIDIA H100: `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`, from the root of a checkout.  Cells,
configurations, traffic mixes and per-layer metrics are files of their
own, found by the names in BENCHMARK.json (harness/manifest.py)."""
