"""The benchmark of ``slate_tpu_torch``: one command runs one cell once
(``python3 slatebench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``).  See ``README.md``."""
