"""1.15, the packages' public surface: every name that an ``__init__.py``
of the JAX package re-exports imports from the port's package of the same
path, and is the object of the port module of the same path (the one listed
exception, ``match.nn.use_pallas``, chooses a TPU kernel and is absent);
``kernel_map_same``, ``kernel_map_down`` and ``kernel_map_up`` give the JAX
functions' integer maps on the inputs of ``tests/test_sparse_core.py``'s
conv oracles; ``device_trace`` writes a trace file. That importing the
packages loads no JAX and no triton is held in
``test_torch_port_imports.py``."""
import ast
import importlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imfnet_tpu.sparse import coords as JC
from imfnet_tpu.sparse import kernel_map as JKM

from imfnet_tpu_torch.sparse import coords as PC
from imfnet_tpu_torch.sparse import kernel_map as PKM
from imfnet_tpu_torch.utils.timer import device_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_ONLY = {("imfnet_tpu.match.nn", "use_pallas")}


def _reexports():
    """(package, module, name) of every ``from imfnet_tpu... import`` of
    every ``__init__.py`` of the JAX package."""
    out = []
    for init in sorted((REPO / "imfnet_tpu").rglob("__init__.py")):
        package = ".".join(init.relative_to(REPO).parent.parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("imfnet_tpu"):
                out += [(package, node.module, a.name) for a in node.names]
    return out


REEXPORTS = _reexports()


def _port(name: str) -> str:
    return "imfnet_tpu_torch" + name[len("imfnet_tpu"):]


def test_the_jax_package_reexports_76_names_from_eleven_inits():
    assert len(REEXPORTS) == 76
    assert len({p for p, _, _ in REEXPORTS}) == 11
    assert not TPU_ONLY & {(m, n) for _, m, n in REEXPORTS}


@pytest.mark.parametrize("package,module,name", REEXPORTS,
                         ids=[f"{p}.{n}" for p, _, n in REEXPORTS])
def test_each_reexport_imports_from_the_port(package, module, name):
    jax_obj = getattr(importlib.import_module(module), name)
    port_package = importlib.import_module(_port(package))
    got = getattr(port_package, name)
    assert got is getattr(importlib.import_module(_port(module)), name)
    assert callable(got) == callable(jax_obj) and isinstance(got, type) == isinstance(jax_obj, type)


def test_use_pallas_is_tpu_only_and_documented():
    import imfnet_tpu.match.nn as jnn

    import imfnet_tpu_torch.match as pmatch
    import imfnet_tpu_torch.match.nn as pnn

    for module, name in TPU_ONLY:
        assert hasattr(importlib.import_module(module), name)
        assert not hasattr(importlib.import_module(_port(module)), name)
        assert name in pmatch.__doc__
    assert callable(jnn.use_pallas) and not hasattr(pnn, "use_pallas")


def test_models_keeps_load_model():
    from imfnet_tpu_torch.models import MODELS, load_model

    assert load_model("ResUNetBN2C") is MODELS["ResUNetBN2C"]


# ---- kernel maps: the inputs of tests/test_sparse_core.py's conv oracles ------

def _random_coords(rng, n, span, batches):
    c = np.stack([rng.randint(0, batches, n), rng.randint(-span, span, n),
                  rng.randint(-span, span, n), rng.randint(-span, span, n)], axis=1)
    c = c.astype(np.int32)
    _, idx = np.unique(c, axis=0, return_index=True)
    c = c[np.sort(idx)]
    return c[np.lexsort((c[:, 3], c[:, 2], c[:, 1], c[:, 0]))]


def _padded(coords, n_pad):
    out = np.full((n_pad, 4), int(JC.PAD_COORD), np.int32)
    out[:len(coords)] = coords
    return out, np.arange(n_pad) < len(coords)


@pytest.mark.parametrize("n,span,batches,kernel_size", [(150, 5, 2, 3), (100, 4, 1, 5)])
@pytest.mark.parametrize("tensor_stride", [1, 2])
def test_kernel_map_same_equals_jax(n, span, batches, kernel_size, tensor_stride):
    """``_engine_conv``'s k3 and k5 inputs (``test_sparse_conv_k3_vs_oracle``,
    ``_k5_vs_oracle``), at tensor stride 1 as there and at 2."""
    coords = _random_coords(np.random.RandomState(0), n, span, batches)
    n_pad = 1 << int(np.ceil(np.log2(len(coords) + 8)))
    padded, valid = _padded(coords, n_pad)
    want = np.asarray(JKM.kernel_map_same(jnp.asarray(padded), jnp.asarray(valid),
                                          kernel_size, tensor_stride))
    got = PKM.kernel_map_same(torch.from_numpy(padded), torch.from_numpy(valid),
                              kernel_size, tensor_stride)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:len(coords)] >= 0).any() and (want[len(coords):] == -1).all()


def test_kernel_map_down_and_up_equal_jax():
    """``test_strided_down_and_up_conv_vs_oracle``'s input: the stride-2
    table, the down map from the fine level and the up map back to it."""
    coords = _random_coords(np.random.RandomState(0), 120, 6, 2)
    padded, valid = _padded(coords, 256)
    j_out, j_n = JC.stride_coords(jnp.asarray(padded), jnp.asarray(valid), 2, 256)
    j_out_valid = jnp.arange(256) < j_n
    p_in, p_valid = torch.from_numpy(padded), torch.from_numpy(valid)
    p_out, p_n = PC.stride_coords(p_in, p_valid, 2, 256)
    p_out_valid = torch.arange(256) < p_n
    m = int(j_n)
    assert int(p_n) == m
    np.testing.assert_array_equal(p_out.numpy()[:m], np.asarray(j_out)[:m])

    want_down = np.asarray(JKM.kernel_map_down(jnp.asarray(padded), jnp.asarray(valid),
                                               j_out, j_out_valid, 3, 1))
    got_down = PKM.kernel_map_down(p_in, p_valid, p_out, p_out_valid, 3, 1)
    np.testing.assert_array_equal(got_down.numpy(), want_down)
    want_up = np.asarray(JKM.kernel_map_up(j_out, j_out_valid, jnp.asarray(padded),
                                           jnp.asarray(valid), 3, 1))
    got_up = PKM.kernel_map_up(p_out, p_out_valid, p_in, p_valid, 3, 1)
    np.testing.assert_array_equal(got_up.numpy(), want_up)
    assert (want_down[:m] >= 0).any() and (want_up[:len(coords)] >= 0).any()


def test_device_trace_writes_a_trace_file(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
