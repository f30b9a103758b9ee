"""The port's examples (``examples/torch_*.py``) on the CPU, at the
reference scripts' default sizes, through their ``main(argv)`` with
``--device cpu``; and what they rest on against the JAX package: the
assigned-architecture list, the configs' parameter counts, the H100 cost
model spec. ``tests/test_torch_gradual_example.py`` runs
``torch_gradual_pruning.py``. Each member a script prints must meet its
target on its table."""
import dataclasses
import importlib.util
import os
import re

import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import ASSIGNED as REF_ASSIGNED
from repro_torch import configs
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

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


def load_example(name):
    """An ``examples/`` script as a module (they are not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def achieved(out, pattern):
    """(target, achieved) pairs of the printed lines matching
    ``pattern``."""
    return [(float(t), float(a)) for t, a in re.findall(pattern, out)]


def test_assigned_is_the_references_list():
    assert configs.ASSIGNED == REF_ASSIGNED
    for name in configs.NOT_PORTED:
        assert name in configs.ASSIGNED
        with pytest.raises(KeyError, match="not ported yet"):
            configs.get_config(name)


@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_param_counts_match_the_reference(name):
    assert configs.ARCHS[name].param_counts() == \
        REF_ARCHS[name].param_counts()
    for active in (False, True):
        assert configs.ARCHS[name].num_params(active) == \
            REF_ARCHS[name].num_params(active)


def test_h100_spec_is_the_data_sheet_and_envs_name_their_hardware():
    assert dataclasses.asdict(H100_SXM) == {
        "name": "h100-sxm-datasheet", "peak_flops": 989e12,
        "hbm_bw": 3.35e12, "ici_bw": 0.0, "hbm_bytes": 80e9,
        "op_overhead": 5e-6}
    with pytest.raises(TypeError):
        InferenceEnv(batch=16, seq=128)


def test_quickstart_runs_on_the_cpu(capsys):
    res = load_example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "model: gpt2-tiny  params=0.48M" in out
    assert len(re.findall(r"step +\d+ loss", out)) == 3
    got = achieved(out, r"target +([\d.]+)x -> achieved ([\d.]+)x")
    assert [t for t, _ in got] == [1.5, 2.0, 3.0]
    assert all(a >= t for t, a in got)
    for t, v in res.variants.items():
        assert v.speedup >= t


def test_serve_pruned_runs_on_the_cpu(capsys):
    res = load_example("torch_serve_pruned").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(re.findall(r"(dense|pruned) +prefill +[\d.]+ ms  decode "
                          r"+[\d.]+ ms/token", out)) == 2
    m = re.search(r"guaranteed-by-table ([\d.]+)x", out)
    assert m and float(m.group(1)) >= 2.0
    assert res.variants[2.0].speedup >= 2.0


@pytest.mark.parametrize("arch", load_example(
    "torch_oneshot_prune_arch").PORTED)
def test_oneshot_prune_arch_runs_every_ported_arch(arch, capsys):
    ex = load_example("torch_oneshot_prune_arch")
    assert ex.PORTED == [a for a in REF_ASSIGNED
                         if a not in configs.NOT_PORTED]
    res, pm = ex.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"arch={arch} (reduced)  prunable modules: ")
    got = achieved(out, r"target ([\d.]+)x -> achieved ([\d.]+)x")
    assert len(got) == 1 and got[0][1] >= got[0][0] == 2.0
    assert res.variants[2.0].speedup >= 2.0
    # an encoder/decoder model is not shrunk (pm is None): one line for
    # each decoder layer
    layers = (configs.smoke_config(arch).num_layers if pm is None
              else len(pm.layers))
    assert len(re.findall(r"  layer \d+: ", out)) == layers
