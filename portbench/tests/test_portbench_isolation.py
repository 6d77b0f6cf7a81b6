"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the measured program."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
             "graphlearninglayer_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(BENCH)), m) for f in files
           for m in _imports(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] not in ("torch", "numpy", "contextlib",
                                      "__future__")]
    assert not bad, bad


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's: only whole names match
    assert "graphlearninglayer_tpu_torch".split(".")[0] not in FORBIDDEN
