"""portbench: the benchmark of pc_accumulation_lib_tpu_torch on the H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of BENCHMARK.json once and prints one JSON
line last. Everything here is found by name from BENCHMARK.json: a
configuration in configs/, a traffic mix in traffic/ (data read by the
driver it names in drivers/), a per-layer metric's reader in metrics/,
a cell's correctness limits in limits/.
"""
