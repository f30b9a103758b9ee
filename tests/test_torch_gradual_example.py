"""``examples/torch_gradual_pruning.py`` on the CPU at the reference
script's default sizes (a 4-layer GPT-2 pretrained 120 steps, targets
1.5x/2x/3x, 20 finetune steps each) through its ``main(argv)`` with
``--device cpu``: every member meets its target, and a second run on the
same checkpoint directory resumes the finished family from its artifacts
to the same members."""
import importlib.util
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gradual_pruning_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_gradual_pruning",
        os.path.join(ROOT, "examples", "torch_gradual_pruning.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    argv = ["--ckpt", str(tmp_path), "--device", "cpu"]
    fam = ex.main(argv)
    out = capsys.readouterr().out
    assert "model: gpt2-tiny params=0.5M" in out
    assert "pretrained to step 120, loss " in out
    got = [(float(t), float(a)) for t, a in
           re.findall(r"  ([\d.]+)x -> ([\d.]+)x  loss", out)]
    assert [t for t, _ in got] == [1.5, 2.0, 3.0]
    assert all(a >= t for t, a in got)
    assert all(v.achieved >= v.target for v in fam)
    again = ex.main(argv)
    out = capsys.readouterr().out
    assert "no step taken" in out and "restored (stage done)" in out
    assert [(v.assignment, v.achieved, v.loss_after_ft) for v in again] == \
        [(v.assignment, v.achieved, v.loss_after_ft) for v in fam]
