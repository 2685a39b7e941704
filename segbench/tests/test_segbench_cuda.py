"""A short run of a cell on the card, through the benchmark's command.
Skips where there is no card; the decision is made inside the test."""

import json
import os
import subprocess
import sys

import pytest

from segbench import cells


@pytest.mark.cuda
def test_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    p = subprocess.run(
        [sys.executable, os.path.join(cells.HERE, "run.py"), "--workload",
         "cvppp256_infer_sparse", "--seed", str(2 ** 31 + 3), "--seconds",
         "2", "--trace", "0"], capture_output=True, text=True,
        cwd=cells.ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["infer_img_per_s"]["value"] > 0
