"""The benchmark of ``approximategps_tpu_torch`` on an NVIDIA H100 (see
README.md): one cell a run, driven by ``BENCHMARK.json`` and the files it
names."""
