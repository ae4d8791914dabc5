"""The port's framework-free copies against ``coma_tpu``'s: the CHORUS
keypoint-filter grammar (``config/filtering.py``: the table and every
filter's verdict on seeded visibility sets, equal), ``utils/ids.py`` (the
same ids from the same ``random.Random``), ``utils/profiling.py``
(``torch.profiler`` trace, sync, timing on the CPU) and ``python -m
coma_tpu_torch`` (every CLI of the port listed)."""
import dataclasses
import json
import os
import pkgutil
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from coma_tpu.config import filtering as J
from coma_tpu.utils import ids as j_ids
from coma_tpu_torch.config import filtering as T
from coma_tpu_torch.utils import ids as t_ids
from coma_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted({n.strip() for coco, _ in J.KEYPOINT_FILTERS.values()
                for n in coco.replace("|", "/").replace(",", "/").split("/") if n.strip()})


def test_filter_table_equal():
    assert T.KEYPOINT_FILTERS == J.KEYPOINT_FILTERS
    assert T.DEFAULT_KEYPOINT_FILTER_NUM == J.DEFAULT_KEYPOINT_FILTER_NUM == 3
    for coco, _ in J.KEYPOINT_FILTERS.values():
        got, want = T.parse_keypoint_filter(coco), J.parse_keypoint_filter(coco)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("num", sorted(J.KEYPOINT_FILTERS))
def test_filter_verdicts_equal(num):
    rng = np.random.default_rng(num)
    for _ in range(200):
        visible = {n for n in NAMES if rng.uniform() < rng.uniform()}
        assert T.keypoint_filter_passes(num, visible) == J.keypoint_filter_passes(num, visible)
        mapping = {n: n in visible for n in NAMES}
        assert T.keypoint_filter_passes(num, mapping) == J.keypoint_filter_passes(num, mapping)


def test_generate_id_equal():
    assert t_ids.generate_id(32, random.Random(7)) == j_ids.generate_id(32, random.Random(7))
    got = t_ids.generate_id(12)
    assert len(got) == 12 and got.isalnum() and got == got.lower()


def test_profiling_on_the_cpu(tmp_path):
    x = torch.arange(6.0)
    assert profiling.sync({"a": x, "b": [x + 1, "text"]}) == 1.0
    seconds, out = profiling.timed(lambda t: t * 2, x, iters=2)
    assert seconds >= 0 and torch.equal(out, x * 2)
    with profiling.trace(str(tmp_path / "trace")):
        (x @ x).item()
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert "traceEvents" in trace and len(trace["traceEvents"]) > 0


def test_main_lists_every_cli():
    out = subprocess.run([sys.executable, "-m", "coma_tpu_torch"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    import coma_tpu_torch.cli

    for mod in pkgutil.iter_modules(coma_tpu_torch.cli.__path__):
        if mod.name != "_common":
            assert f"python -m coma_tpu_torch.cli.{mod.name}\n" in out.stdout, mod.name
    for name in ("evaluate", "visualize", "train_segmenter"):
        assert f"coma_tpu_torch.cli.{name}" in out.stdout
