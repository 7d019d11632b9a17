"""The benchmark of `hbird_tpu_torch` on one NVIDIA H100.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
specific to a configuration, a traffic mix or a metric lives in a file of
its own that the harness finds by name: `configs/<config>.json`,
`traffic/<traffic>.json`, `limits/<cell>.json`, `jobs/<kind>.py` and
`metrics/<metric>.py`.
"""
