"""The port imports neither JAX (nor flax, nor optax, nor pandas) nor the JAX
package, not even inside a function."""

import ast
import os
import pkgutil
import subprocess
import sys

import efficient_gnns_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, sys
for name in ("jax", "jaxlib", "flax", "optax", "pandas"):
    sys.modules[name] = None  # any import of them raises ImportError
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pandas",
                                    "efficient_gnns_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
"""


def test_port_imports_without_jax():
    modules = [m.name for m in pkgutil.walk_packages(
        efficient_gnns_tpu_torch.__path__, "efficient_gnns_tpu_torch.")]
    for name in ("cli.arxiv", "cli.gat_teacher", "ops.cuda.segment_sum",
                 "ops.cuda.segment_heads", "ops.cuda.segment_thin", "ops.attention",
                 "ops.edge_softmax", "ops.sddmm", "train.gat_teacher",
                 "distill.artifacts", "ops.cuda.segment_sddmm", "ops.spmm",
                 "ops.segment", "distill.criteria", "graphs.preprocess",
                 "models.gnns", "models.layers", "models.transplant",
                 "train.config", "train.node_trainer", "graphs.hub_dense",
                 "ops.hub_attention", "ops.dispatch", "cli.sign", "data.ogb",
                 "sampling.minibatch", "sampling.hop_precompute", "train.checkpoint",
                 "train.sign_trainer", "data.ppi", "train.ppi_trainer", "cli.ppi",
                 "graphs.hetero", "data.mag", "native.host", "sampling.saint",
                 "train.layerwise", "train.mag_trainer", "cli.mag", "graphs.batching",
                 "ops.sorted_segment", "data.molhiv", "models.mol", "train.mol_trainer",
                 "cli.mol", "analysis", "analysis.timing", "analysis.microbench",
                 "analysis.correlation", "analysis.curves", "cli.submit", "cli.sweep",
                 "cli.results", "parallel", "parallel.mesh", "parallel.launch",
                 "parallel.collectives", "parallel.partition", "parallel.ring",
                 "parallel.dryrun", "parallel.sharded_trainer", "parallel.tensor",
                 "tracing"):
        assert f"efficient_gnns_tpu_torch.{name}" in modules, name
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, "efficient_gnns_tpu_torch", *modules],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_statement_anywhere():
    # imports inside functions run only when called; read every import
    # statement of the port and of chip_smoke.py instead
    pkg = os.path.dirname(efficient_gnns_tpu_torch.__file__)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    banned = {"jax", "jaxlib", "flax", "optax", "pandas", "efficient_gnns_tpu"}
    found = []
    for path in files:
        with open(path) as f:
            stack = [(ast.parse(f.read(), path), None)]
        while stack:  # every node with the name of the function around it
            node, scope = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = node.name
            stack += [(child, scope) for child in ast.iter_child_nodes(node)]
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(path, scope, n) for n in names if n.split(".")[0] in banned]
    assert len(files) > 20 and not found, found
