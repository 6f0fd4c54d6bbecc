"""The benchmark of ``mdgan_tpu_torch`` on the H100: one cell, one run.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``perfbench/README.md``.  Nothing here imports JAX or the JAX package;
``perfbench.reference`` and the family modules of ``perfbench/configs``
import nothing of ``mdgan_tpu_torch`` either.
"""
