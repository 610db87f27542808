"""The benchmark of the PyTorch port (``repro_torch``): one command runs
one cell once (``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``).  See ``bench/README.md``."""
