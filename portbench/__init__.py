"""The port's benchmark: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
