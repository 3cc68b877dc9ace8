"""wfbench: the benchmark of the PyTorch and CUDA port, ``waveform_tpu_torch``.

``python3 -m wfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result as the last line of standard output.
"""
