"""The benchmark of dynamicfusion_body_tpu_torch on one NVIDIA H100: its
harness (run.py), inputs (scene.py), plain reference (reference/), roofline
yardstick (counts.py) and metric readers (metrics/), all found by the names
in BENCHMARK.json."""
