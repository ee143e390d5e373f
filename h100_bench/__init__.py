"""The H100 benchmark of felics_tpu_torch: one cell a run, from
``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` at the root of a checkout (see ``harness.py``)."""
