"""Test set-up for the benchmark's own tests: the harness (``perfbench/``)
and the port (``src/``) on the path, and the tiny sizes the CPU runs."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# every cell's configuration and mix cut to what a CPU test holds: widths
# and rows shrink, nothing else changes
TINY = {
    "cylon35m": {"config": {"rows": 4000, "capacity_per_rank": 2064,
                            "key_range": 4000}},
    "falcon-mamba-7b": {
        "config": {"hidden_size": 512, "num_hidden_layers": 6,
                   "intermediate_size": 1024, "time_step_rank": 32,
                   "vocab_size": 4096,
                   "deployment": {"ranks": 2, "max_batch": 4, "max_seq": 300,
                                  "decode_chunk": 8, "prefill_ranks": 1,
                                  "decode_ranks": 1}},
        "traffic": {"prompt": {"dist": "loguniform", "min": 16, "max": 128},
                    "answer": {"dist": "uniform", "min": 4, "max": 12},
                    "clients": 8}},
}


def tiny(workload: str) -> dict:
    import copy
    cfg = workload.split(".")[0]
    return copy.deepcopy(TINY[cfg])


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs at the cell's size on the "
                    "card)")
    return torch.device("cuda:0")
