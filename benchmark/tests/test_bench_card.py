"""On the card: a short run of the dense cell end to end, through the
benchmark's command, comes out correct and prints the line the driver
reads. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import BENCH


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_is_correct(card, traced):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "metr-la.train", "--seed", "2147483659", "--seconds", "2",
         "--trace", str(traced)], capture_output=True, text=True,
        cwd=BENCH.parent, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "compared"
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "mfu.metr_train" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"metr_train_samples_per_s",
                                        "peak_mem_gib", "setup_s"}
