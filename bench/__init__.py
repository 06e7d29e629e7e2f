"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  Everything a
cell is made of is found by name: its configuration in
``bench/configs/<config>.json``, its traffic mix in
``bench/traffic/<traffic>.json``, the data generator the configuration
names in ``bench/gen/``, the operation the traffic names in ``bench/ops/``,
the guarantee the configuration states in ``bench/reference/``, and each
metric's reader in ``bench/e2e/<name>.py`` or
``bench/metrics/<family>.py``.
"""
