"""The port stands alone: it never imports JAX or the JAX package, its
entry points refuse to run on a missing card unless asked for the CPU,
and its CLI gives the JAX CLI's answer."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from distributedlpsolver_tpu import cli as jax_cli
from distributedlpsolver_tpu_torch import cli
from distributedlpsolver_tpu_torch.backends import get_backend
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.models import random_dense_lp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "distributedlpsolver_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "distributedlpsolver_tpu"}


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = {(os.path.relpath(f, ROOT), r) for f in files for r in _imported_roots(f) if r in FORBIDDEN}
    assert not bad


def test_importing_the_port_and_its_cli_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import distributedlpsolver_tpu_torch, distributedlpsolver_tpu_torch.cli\n"
        "import distributedlpsolver_tpu_torch.backends, distributedlpsolver_tpu_torch.interop\n"
        "import distributedlpsolver_tpu_torch.backends.batched, distributedlpsolver_tpu_torch.ipm.warm\n"
        "import distributedlpsolver_tpu_torch.serve, distributedlpsolver_tpu_torch.serve.service\n"
        "import distributedlpsolver_tpu_torch.serve.autotune, distributedlpsolver_tpu_torch.supervisor\n"
        "import distributedlpsolver_tpu_torch.obs.stats, distributedlpsolver_tpu_torch.native\n"
        "import distributedlpsolver_tpu_torch.backends.auto, distributedlpsolver_tpu_torch.backends.first_order\n"
        "import distributedlpsolver_tpu_torch.models.structure, distributedlpsolver_tpu_torch.utils.accel\n"
        "import distributedlpsolver_tpu_torch.backends.sparse_iterative, distributedlpsolver_tpu_torch.ops.ildl\n"
        "import distributedlpsolver_tpu_torch.ops.sparse, distributedlpsolver_tpu_torch.ops.pcg\n"
        "import distributedlpsolver_tpu_torch.ops.ell_spmv, distributedlpsolver_tpu_torch.ops.kernel_build\n"
        "import distributedlpsolver_tpu_torch.net, distributedlpsolver_tpu_torch.net.chaos\n"
        "import distributedlpsolver_tpu_torch.serve.elastic, distributedlpsolver_tpu_torch.obs\n"
        "import distributedlpsolver_tpu_torch.utils.utilization\n"
        "import distributedlpsolver_tpu_torch.parallel, distributedlpsolver_tpu_torch.backends.sharded\n"
        "import distributedlpsolver_tpu_torch.distributed.launcher\n"
        "import distributedlpsolver_tpu_torch.distributed.worker\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'distributedlpsolver_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_serving_modules_are_scanned():
    """The AST scan above covers the serving stack, the sparse tier and the
    network plane this package added."""
    rel = {os.path.relpath(f, PORT) for f in _port_sources()}
    for mod in ("serve/service.py", "serve/buckets.py", "serve/scheduler.py", "serve/records.py",
                "serve/warmcache.py", "serve/journal.py", "serve/autotune.py", "obs/stats.py",
                "supervisor/supervisor.py", "supervisor/watchdog.py", "supervisor/adaptive.py",
                "supervisor/faults.py", "native/__init__.py", "native/build.py",
                "backends/auto.py", "backends/cpu.py", "backends/cpu_native.py",
                "backends/cpu_sparse.py", "backends/first_order.py", "models/structure.py",
                "utils/threefry.py", "utils/accel.py", "backends/sparse_iterative.py",
                "ops/sparse.py", "ops/pcg.py", "ops/ildl.py", "ops/ell_spmv.py",
                "ops/kernel_build.py", "net/__init__.py", "net/protocol.py", "net/admission.py",
                "net/registry.py", "net/server.py", "net/router.py", "net/chaos.py",
                "serve/elastic.py", "obs/report.py", "obs/agg.py", "utils/utilization.py",
                "parallel/mesh.py", "parallel/runtime.py", "distributed/world.py",
                "distributed/launcher.py", "distributed/worker.py", "backends/sharded.py"):
        assert mod in rel


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(random_dense_lp(4, 10, seed=0), backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["solve", os.path.join(ROOT, "tests", "fixtures", "maximize.mps"), "--json"])
    assert get_backend("cuda", device="cpu").device.type == "cpu"
    # The default backend, auto, and the PDHG backend raise too: auto never
    # takes its CPU route because the card is missing.
    for name in ("auto", "pdlp", "sparse-iterative", "sharded"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend(name)
        assert get_backend(name, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(random_dense_lp(4, 10, seed=0))


def test_cli_json_matches_the_jax_cli(capsys):
    path = os.path.join(ROOT, "tests", "fixtures", "maximize.mps")
    rc = cli.main(["solve", path, "--device", "cpu", "--json"])
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc_j = jax_cli.main(["solve", path, "--json", "--quiet"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == rc_j == 0
    assert port["status"] == ref["status"] == "optimal"
    assert abs(port["objective"] - ref["objective"]) <= 1e-8 * (1 + abs(ref["objective"]))
    # Both CLIs default to auto, which routes this CPU run to the native kernels.
    assert port["backend"] == ref["backend"] == "auto(cpu-native)"


def test_cli_lists_the_ports_backends(capsys):
    assert cli.main(["backends"]) == 0
    assert capsys.readouterr().out.split() == [
        "auto", "block", "block-angular", "cpu", "cpu-native", "cpu-sparse", "cuda", "dense",
        "first-order", "inexact-ipm", "mesh", "native", "numpy", "pdhg", "pdlp", "scenario", "schur",
        "scipy", "sharded", "sparse", "sparse-iterative", "sparse-pcg", "torch", "tpu-sharded"]
