"""The PyTorch port stands alone: it imports no JAX, no flax and nothing of
the JAX package, and its entry points refuse to fall back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "imfnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "imfnet_tpu")


def _port_sources():
    yield from sorted(PORT.rglob("*.py"))
    yield REPO / "chip_smoke.py"


def test_import_every_submodule_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import imfnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(imfnet_tpu_torch.__path__, "
        "'imfnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            # "imfnet_tpu_torch" is the port itself; "imfnet_tpu" is not
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_scan_covers_the_cli_the_trainer_and_the_split_lists():
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    for name in ("imfnet_tpu_torch/cli.py", "imfnet_tpu_torch/config.py",
                 "imfnet_tpu_torch/data/datasets.py", "imfnet_tpu_torch/train/trainer.py",
                 "imfnet_tpu_torch/train/checkpoint.py", "imfnet_tpu_torch/geom/image.py",
                 "imfnet_tpu_torch/geom/ply.py", "imfnet_tpu_torch/geom/trajectory.py",
                 "imfnet_tpu_torch/utils/timer.py", "chip_smoke.py",
                 "imfnet_tpu_torch/eval/extract.py", "imfnet_tpu_torch/eval/threedmatch.py",
                 "imfnet_tpu_torch/eval/compare.py", "imfnet_tpu_torch/eval/kitti.py",
                 "imfnet_tpu_torch/match/icp.py", "imfnet_tpu_torch/sparse/build.py",
                 "imfnet_tpu_torch/utils/hashing.py", "imfnet_tpu_torch/utils/native.py",
                 "imfnet_tpu_torch/utils/visualization.py",
                 "imfnet_tpu_torch/models/simpleunet.py", "imfnet_tpu_torch/utils/torch_weights.py",
                 "imfnet_tpu_torch/dam/dam.py", "imfnet_tpu_torch/data/offline.py"):
        assert name in names, name
    # the split lists are the port's own copy, resolved beside its loader
    from imfnet_tpu_torch.data import datasets
    for split in ("train", "val", "test"):
        for data in ("3dmatch", "kitti"):
            path = datasets._resolve_data_file(f"./config/{split}_{data}.txt")
            assert pathlib.Path(path).resolve().is_relative_to(PORT)


def test_trainer_and_datasets_import_neither_pil_nor_jax():
    code = (
        "import sys\n"
        "import imfnet_tpu_torch.data.datasets\n"
        "import imfnet_tpu_torch.train.trainer\n"
        "import imfnet_tpu_torch.cli\n"
        "import imfnet_tpu_torch.eval.threedmatch\n"
        "import imfnet_tpu_torch.eval.compare\n"
        "import imfnet_tpu_torch.eval.kitti\n"
        "import imfnet_tpu_torch.dam.dam\n"
        "import imfnet_tpu_torch.data.offline\n"
        "import imfnet_tpu_torch.utils.visualization\n"
        "import imfnet_tpu_torch.utils.torch_weights\n"
        "import imfnet_tpu_torch.models.simpleunet\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN + ('PIL',)!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_point_raises_without_cuda(monkeypatch):
    from imfnet_tpu_torch.pipeline import PairRegistrar
    from imfnet_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PairRegistrar()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_never_fall_back_for_a_non_cpu_tensor():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrappers launch their kernel or raise."""
    from imfnet_tpu_torch.match.nn_kernel import flash_nn
    from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm

    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_gemm(x, torch.zeros((4, 27), dtype=torch.int32, device="meta"),
                    torch.zeros((27, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_nn(torch.zeros((4, 3), device="meta"),
                 torch.zeros((5, 3), device="meta"))


def test_kernel_wrappers_check_their_inputs():
    from imfnet_tpu_torch.match.nn_kernel import flash_nn
    from imfnet_tpu_torch.sparse.conv_kernel import gather_gemm

    x = torch.zeros((4, 8))
    nbr = torch.zeros((4, 27), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_gemm(x, nbr.long(), torch.zeros((27, 8, 8)))
    with pytest.raises(ValueError):
        gather_gemm(x, nbr, torch.zeros((27, 7, 8)))
    with pytest.raises(TypeError):
        gather_gemm(x.half(), nbr, torch.zeros((27, 8, 8)).half())
    with pytest.raises(ValueError):
        gather_gemm(x, nbr, torch.zeros((8, 27, 8)).transpose(0, 1))
    with pytest.raises(TypeError):
        flash_nn(torch.zeros((4, 3), dtype=torch.float64), torch.zeros((5, 3)))
    with pytest.raises(ValueError):
        flash_nn(torch.zeros((4, 3)), torch.zeros((5, 3)),
                 torch.ones(4, dtype=torch.bool))
