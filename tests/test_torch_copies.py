"""The port's copies of the JAX package's numpy modules stay copies.

The port imports nothing of ``repro``, so it keeps its own copy of each
JAX-free module it needs.  Each copy's AST, with every docstring dropped
and ``repro_torch`` read as ``repro``, must equal the original's: the
two may differ only in their docstrings and their import prefix.  This
check stands in for porting the 14 scheduler test files, which exercise
the originals (``tests/test_scheduler.py`` and the others).

One copy holds more than the original: the port's ``ModelConfig``
(``configs/base.py``) ends with fields of its own, ``PORT_FIELDS``, which
the JAX package has not.  Its case drops exactly those fields from the
copy's ``ModelConfig`` and then compares as the others do, so every field
the JAX package has, its type and its default, stays the original's.
"""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
CONFIGS = sorted(p.name for p in (SRC / "repro" / "configs").glob("*.py"))
COPIES = ([f"configs/{name}" for name in CONFIGS]
          + ["data/pipeline.py", "utils/hashing.py"]
          + [f"core/{name}.py" for name in (
              "barrier", "sla", "buffers", "device_proxy", "splicing",
              "validation")]
          + [f"scheduler/{name}.py" for name in (
              "curves", "costs", "types", "reliability", "telemetry",
              "job_table", "node_map", "policy", "simulator", "serving")])
# the fields of the port's ModelConfig that the JAX package has not
PORT_FIELDS = ("layer_types", "embedding_multiplier", "attention_multiplier",
               "residual_multiplier", "logits_scaling", "norm_eps")


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and reads the ``repro_torch`` prefix as ``repro``;
    in a copy (``port``), an import of ``repro`` itself is marked, so that
    it cannot pass for the original's."""

    def __init__(self, port: bool):
        self.port = port

    def _module(self, name: str) -> str:
        root = name.split(".")[0]
        if root == "repro_torch":
            return "repro" + name[len("repro_torch"):]
        if root == "repro" and self.port:
            return "<the JAX package>." + name
        return name

    def _drop_docstring(self, node):
        body = node.body
        if body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return self.generic_visit(node)

    visit_Module = visit_ClassDef = _drop_docstring
    visit_FunctionDef = visit_AsyncFunctionDef = _drop_docstring

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = self._module(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._module(alias.name)
        return node


def _without_port_fields(tree: ast.Module) -> ast.Module:
    """``tree`` with the ``PORT_FIELDS`` of its ``ModelConfig`` dropped;
    each of them must be there."""
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "ModelConfig")
    named = {n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)}
    missing = set(PORT_FIELDS) - named
    assert not missing, f"the port's ModelConfig lacks {sorted(missing)}"
    cls.body = [n for n in cls.body if not (isinstance(n, ast.AnnAssign)
                                            and n.target.id in PORT_FIELDS)]
    return tree


def _normalised(path: Path, port: bool = True,
                port_fields: bool = False) -> str:
    tree = _Normalise(port).visit(ast.parse(path.read_text(), str(path)))
    if port_fields:
        tree = _without_port_fields(tree)
    return ast.dump(tree, include_attributes=False)


def test_every_config_is_covered():
    assert len(CONFIGS) == 13
    assert sorted(p.name for p in (SRC / "repro_torch" / "configs")
                  .glob("*.py")) == CONFIGS


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_original(rel):
    original, copy = SRC / "repro" / rel, SRC / "repro_torch" / rel
    mine = _normalised(copy, port_fields=rel == "configs/base.py")
    assert mine == _normalised(original, port=False), (
        f"src/repro_torch/{rel} differs from src/repro/{rel} in more than "
        f"its docstrings and import prefix")


def test_the_check_sees_a_change_of_code(tmp_path):
    """A copy with one constant changed, or one import left on ``repro``,
    fails; one with its docstrings changed passes."""
    text = (SRC / "repro_torch" / "scheduler" / "costs.py").read_text()
    original = _normalised(SRC / "repro" / "scheduler" / "costs.py",
                           port=False)
    edits = {
        "doc": (text.replace('"""Scheduling cost model', '"""Another title',
                             1), True),
        "code": (text.replace("BLOB_STORE_BANDWIDTH",
                              "HOST_DEVICE_BANDWIDTH", 1), False),
        "import": (text.replace("from repro_torch.utils", "from repro.utils",
                                1), False),
    }
    for name, (edited, same) in edits.items():
        assert edited != text, name
        path = tmp_path / f"{name}.py"
        path.write_text(edited)
        assert (_normalised(path) == original) is same, name


BASE_EDITS = {
    # a field the JAX package has, with its default changed
    "jax_default": ("    rope_theta: float = 10000.0\n",
                    "    rope_theta: float = 500000.0\n"),
    # a field of the port's own that PORT_FIELDS does not name
    "extra_field": ("    norm_eps: float = 1e-6\n",
                    "    norm_eps: float = 1e-6\n    qk_norm: bool = False\n"),
}


@pytest.mark.parametrize("edit", sorted(BASE_EDITS))
def test_the_base_check_sees_a_planted_fault(edit, tmp_path):
    """A copy of the port's ``configs/base.py`` with a JAX field's default
    changed, or with a field of its own that ``PORT_FIELDS`` does not
    name, fails the check that the unedited copy passes."""
    text = (SRC / "repro_torch" / "configs" / "base.py").read_text()
    original = _normalised(SRC / "repro" / "configs" / "base.py",
                           port=False)
    old, new = BASE_EDITS[edit]
    assert text.count(old) == 1
    path = tmp_path / "base.py"
    path.write_text(text)
    assert _normalised(path, port_fields=True) == original
    path.write_text(text.replace(old, new))
    assert _normalised(path, port_fields=True) != original
