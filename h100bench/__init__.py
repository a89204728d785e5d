"""The benchmark of `pcgcv2_torch` on one H100: cells of a configuration
and a traffic mix, end-to-end metrics by the host clock, per-layer metrics
from a traced run, and a plain PyTorch reference that decides `correct`.
Run one cell once with

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
