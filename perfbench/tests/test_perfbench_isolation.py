"""Nothing the benchmark runs imports JAX or the JAX package, compared by
the whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from conftest import ROOT

BLOCK = textwrap.dedent("""
    import sys
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "rag_serving_system_tpu"):
                raise ImportError("refused: " + name)
    sys.meta_path.insert(0, Block())
""")


def _py(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_reference_imports_nothing_of_the_port():
    p = _py("""
        sys.path.insert(0, ".")
        import perfbench.reference, perfbench.judge, perfbench.weights, perfbench.flops
        import perfbench.generator
        tops = {m.split(".")[0] for m in sys.modules}
        assert "rag_serving_system_torch" not in tops, sorted(tops)
        print("ok")
    """)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr


def test_a_whole_run_loads_no_jax(tmp_path):
    p = _py(f"""
        sys.path.insert(0, ".")
        sys.path.insert(0, "perfbench/tests")
        import pathlib, conftest
        tree = conftest.tiny_tree.__wrapped__(pathlib.Path({str(tmp_path)!r}))
        import perfbench.sweep  # every module of the folder
        res = conftest.run_tiny(tree, 31337)
        from perfbench.run import forbidden_modules
        tops = {{m.split(".")[0] for m in sys.modules}}
        assert "rag_serving_system_torch" in tops
        assert forbidden_modules() == [], forbidden_modules()
        print("ok", res["correct"])
    """)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok True"), p.stderr[-3000:]
