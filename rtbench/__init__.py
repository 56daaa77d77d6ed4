"""The benchmark of ``simple_raytracer_tpu_torch``, the PyTorch and CUDA
raytracer: turntable frames through the program's public entry points on
one card or four.  ``python3 rtbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once (README.md)."""
