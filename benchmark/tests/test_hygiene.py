"""Nothing the benchmark runs imports JAX, the JAX package or the port's
harness, and the port only by its public names."""

import ast

from benchmark import cell

FORBIDDEN = {"jax", "multirate_tpu", "bench"}  # top-level packages
PUBLIC = {"multirate_tpu_torch": {"FIRFilter"},
          "multirate_tpu_torch.io": {"StreamingResampler"},
          "multirate_tpu_torch.models": {"Resampler"}}


def test_imports():
    for path in (cell.REPO / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [(a.name, None) for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [(node.module, {a.name for a in node.names})]
            else:
                continue
            for mod, names in mods:
                assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
                assert not mod.startswith("multirate_tpu_torch.bench"), path
                if mod.startswith("multirate_tpu_torch") and names:
                    assert names <= PUBLIC.get(mod, set()), (path, mod)
