"""The top-level-name check for JAX and the JAX package."""

from stereo_bench import harness


def test_catches_jax_and_the_jax_package_by_whole_top_level_name():
    found = harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "ug_stereomatcher_tpu", "ug_stereomatcher_tpu.engine"])
    assert found == sorted(["jax", "jax.numpy", "jaxlib.xla_client",
                            "flax.linen", "ug_stereomatcher_tpu",
                            "ug_stereomatcher_tpu.engine"])


def test_lets_the_port_and_lookalikes_pass():
    assert harness.forbidden_modules(
        ["ug_stereomatcher_tpu_torch", "ug_stereomatcher_tpu_torch.match",
         "jaxtyping", "torch", "stereo_bench.harness"]) == []


def test_the_harness_loads_neither():
    import stereo_bench.check  # noqa: F401
    import stereo_bench.control  # noqa: F401
    import stereo_bench.harness  # noqa: F401
    import stereo_bench.reference  # noqa: F401
    import sys
    mine = [n for n in sys.modules if n.startswith("stereo_bench")]
    assert mine
    # this process may hold JAX from other tests; the harness's own
    # modules must not import it
    import ast
    import pathlib
    root = pathlib.Path(harness.__file__).parent
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not harness.forbidden_modules(names), (path, names)
