"""The benchmark of ``gpumounter_tpu_torch``: one cell, one run, one line.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the machine it
starts on and prints the result as the last line of its standard output.
Nothing here imports JAX or the JAX package; ``benchmark/reference/``
imports nothing of the port either.
"""
