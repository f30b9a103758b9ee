"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
and its entry points (the examples' ``main`` too) run on the GPU unless the
caller asks for the CPU."""
import ast
import importlib.util
import pathlib
import tempfile

import pytest
import torch

from repro_torch.configs import GPT2_SMALL, MAMBA2_2P7B, smoke_config
from repro_torch.core.database import SnapshotCache, build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.latency import build_table
from repro_torch.core.oneshot import calib_loss_fn, oneshot_prune
from repro_torch.core.pipeline import gradual_prune
from repro_torch.core.shrink import shrink
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import init_cache, model_init
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.costmodel import InferenceEnv
from repro_torch.train import Trainer, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "scripts").glob("*torch*.py")) + EXAMPLES


def _imported_modules(path: pathlib.Path, source: str = None):
    source = path.read_text() if source is None else source
    for node in ast.walk(ast.parse(source, str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _rank_scripts():
    """The ``*_SCRIPT`` string constants that the launcher runs as ranks,
    by ``file:name``."""
    for path in RANK_SCRIPT_FILES:
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id.endswith("_SCRIPT"):
                        yield f"{path.name}:{t.id}", (path, node.value.value)


RANK_SCRIPT_FILES = [ROOT / "chip_smoke.py",
                     ROOT / "tests" / "test_torch_sharded.py",
                     ROOT / "tests" / "test_torch_mesh_train.py",
                     ROOT / "tests" / "test_torch_cuda.py"]
RANK_SCRIPTS = dict(_rank_scripts())


@pytest.mark.parametrize("name", sorted(RANK_SCRIPTS))
def test_rank_scripts_import_neither_jax_nor_the_jax_package(name):
    path, source = RANK_SCRIPTS[name]
    bad = [m for m in _imported_modules(path, source)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{name} imports {bad}"


def test_rank_scripts_are_found():
    assert {"chip_smoke.py:SHARDED_SCRIPT",
            "test_torch_cuda.py:SHARDED_CARD_SCRIPT",
            "test_torch_cuda.py:MESH_TRAIN_CARD_SCRIPT",
            "test_torch_sharded.py:PRELUDE_SCRIPT",
            "test_torch_sharded.py:CALIB_SCRIPT",
            "test_torch_sharded.py:DB_SCRIPT",
            "test_torch_sharded.py:MESH_SCRIPT",
            "test_torch_sharded.py:HANG_SCRIPT",
            "test_torch_mesh_train.py:PRELUDE_SCRIPT",
            "test_torch_mesh_train.py:TRAIN_SCRIPT",
            "test_torch_mesh_train.py:FAMILY_SCRIPT",
            "test_torch_mesh_train.py:CLI_SCRIPT"} <= set(RANK_SCRIPTS)


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"oneshot.py", "obs_downdate.py", "flash_attention.py",
            "shrink.py", "engine.py", "ssm.py", "ssd_scan.py",
            "mamba2_2p7b.py", "chip_smoke.py", "bench_torch_ssd.py",
            "moe.py", "phi35_moe_42b.py", "dbrx_132b.py", "bert.py",
            "qwen2_72b.py", "qwen15_110b.py", "internlm2_20b.py",
            "h2o_danube_1p8b.py", "profile_torch_oneshot.py", "adamw.py",
            "schedule.py", "losses.py", "train_step.py", "trainer.py",
            "manager.py", "pipeline.py", "train.py", "integrity.py",
            "report.py", "torch_quickstart.py", "torch_serve_pruned.py",
            "torch_gradual_pruning.py", "torch_oneshot_prune_arch.py",
            "whisper_large_v3.py", "hymba_1p5b.py",
            "llama32_vision_11b.py", "subproc.py", "sharding.py",
            "activation.py", "compression.py"} <= names


def _example_main(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


ENV = InferenceEnv(batch=2, seq=8, hw=None)
TINY = GPT2_SMALL.replace(num_layers=1, d_model=32, d_ff=64, num_heads=2,
                          num_kv_heads=2, vocab_size=64)
MAMBA = MAMBA2_2P7B.replace(num_layers=1, d_model=32, ssm_state=8,
                            ssm_head_dim=16, ssm_chunk=8, vocab_size=64)
MOE = smoke_config("phi3.5-moe-42b-a6.6b")
ENTRY_POINTS = {
    "model_init": lambda: model_init(TINY),
    "model_init[phi3.5-moe]": lambda: model_init(MOE),
    "oneshot_prune[phi3.5-moe]": lambda: oneshot_prune(MOE, {}, [], ENV,
                                                       [2.0]),
    "shrink[phi3.5-moe]": lambda: shrink(MOE, {"layers": {}}, {}, {}),
    "SnapshotCache[phi3.5-moe]": lambda: SnapshotCache(MOE, {}),
    "model_init[mamba2]": lambda: model_init(MAMBA),
    "oneshot_prune[mamba2]": lambda: oneshot_prune(MAMBA, {}, [], ENV,
                                                   [2.0]),
    "shrink[mamba2]": lambda: shrink(MAMBA, {"layers": {}}, {}, {}),
    "init_cache[mamba2]": lambda: init_cache(MAMBA, 1, 8),
    "params_from_numpy": lambda: params_from_numpy({}),
    "collect_hessians": lambda: collect_hessians(TINY, {}, [{}]),
    "build_database": lambda: build_database(TINY, {}, {}),
    "build_table": lambda: build_table(TINY, ENV, "measure"),
    "SnapshotCache": lambda: SnapshotCache(TINY, {}),
    "calib_loss_fn": lambda: calib_loss_fn(TINY, []),
    "oneshot_prune": lambda: oneshot_prune(TINY, {}, [], ENV, [2.0]),
    "shrink": lambda: shrink(TINY, {"layers": {}}, {}, {}),
    "init_cache": lambda: init_cache(TINY, 1, 8),
    "launch.serve": lambda: serve_cli.main(["--arch", "gpt2-small"]),
    "make_train_step": lambda: make_train_step(TINY, TrainConfig()),
    "Trainer": lambda: Trainer(TINY, TrainConfig(), ckpt_dir="unused"),
    "launch.train": lambda: train_cli.main(["--arch", "gpt2-small"]),
    "gradual_prune": lambda: gradual_prune(TINY, {}, ENV, [2.0], iter(()),
                                           []),
    **{f"examples/{p.name}": (lambda p=p: _example_main(p)([]))
       for p in EXAMPLES},
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_train_entry_points_leave_no_checkpoint_behind_without_a_gpu(
        tmp_path, monkeypatch):
    """The trainer, the CLI and the gradual example refuse before they
    make a directory."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TINY, TrainConfig(), ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "gpt2-small", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example_main(ROOT / "examples" / "torch_gradual_pruning.py")([])
    assert not any(tmp_path.iterdir())


def test_cpu_runs_only_when_asked():
    params = model_init(TINY, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
