"""Guards for the PyTorch port: its config copy matches the JAX package's
field for field, and neither the port nor the root chip_smoke.py imports
JAX or the JAX package."""

import ast
import dataclasses
from pathlib import Path

import pytest

from teal_tpu import config as jcfg
from teal_tpu_torch import config as tcfg

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "teal_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_tables_match():
    assert tcfg.PROJS == jcfg.PROJS
    assert tcfg.PROJ_IDX == jcfg.PROJ_IDX
    assert tcfg.PROJ_GROUP == jcfg.PROJ_GROUP
    assert tcfg.MODEL_REGISTRY == jcfg.MODEL_REGISTRY


@pytest.mark.parametrize("name", sorted(jcfg.MODEL_REGISTRY))
def test_model_configs_match(name):
    j = jcfg.get_model_config(name)
    t = tcfg.get_model_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.kv_dim, t.non_embedding_params()) == \
        (j.head_dim, j.kv_dim, j.non_embedding_params())
    for p in jcfg.PROJS:
        assert t.proj_shape(p) == j.proj_shape(p)


def test_sparsity_config_matches():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.SparsityConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.SparsityConfig)}
    assert tf == jf
    assert tcfg.SparsityConfig().replace(enabled=True).enabled


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "teal_tpu")]
    assert not bad, f"{path.name} imports {bad}"
