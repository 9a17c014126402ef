"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

`python3 rkbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the card. Every
configuration, traffic mix and per-layer metric sits in a file of its own
(`configs/<name>.json`, `traffic/<name>.json`, `metrics/<name>.py`), found
by the name that the manifest gives it; the code those files name (the
plain reference and its comparison, the users' and items' generator, the
query items' draw, the storage's byte counts, the client loop) is a
module found by name too (`manifest.py`). Nothing here imports JAX or the
JAX package `repro`.
"""
