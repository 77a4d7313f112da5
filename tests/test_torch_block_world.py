"""The block-angular tier over a world of processes (gloo on the CPU): the
K axis over the world's ranks, the Schur sum and the linking factor's
panel sums across the process boundary.

One world of 2 runs the cases (``sharded_cases`` with ``backend:
"block"``): the reference's K = 8 case and a ragged K = 5 (a dead block
on rank 1). Held: both ranks the same x bits and iterations, each rank its
K/2 blocks, the JAX package's mesh solve's iterations and its objective
within 1e-8, and the bits of the port's own local mesh of 2 (the same
code: a sum of two parts is the same addition whichever member adds it).
"""

import functools
import hashlib

import jax
import numpy as np
import pytest

from distributedlpsolver_tpu.backends import block_angular as jba
from distributedlpsolver_tpu.ipm import solve as jax_solve
from distributedlpsolver_tpu.models import generators as jgen
from distributedlpsolver_tpu.parallel import mesh as jmesh_lib
from distributedlpsolver_tpu_torch.backends.block_angular import BlockAngularBackend
from distributedlpsolver_tpu_torch.distributed.launcher import run_world
from distributedlpsolver_tpu_torch.ipm import solve
from distributedlpsolver_tpu_torch.models import generators as tgen
from distributedlpsolver_tpu_torch.parallel import mesh as mesh_lib
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (blocks, block_m, block_n, link, seed) of the world's cases.
CASES = [(8, 10, 24, 6, 3), (5, 8, 20, 5, 1)]


def _spec(case):
    K, mb, nb, link, seed = case
    return {"backend": "block", "instance": "block", "blocks": K, "block_m": mb, "block_n": nb,
            "link": link, "seed": seed, "sparse": False, "tol": 1e-8}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    work = tmp_path_factory.mktemp("block_world2")
    res = run_world("sharded_cases", {"cases": [_spec(c) for c in CASES]}, world_size=2,
                    workdir=str(work), device="cpu", timeout=240)
    assert {(out["pg_backend"], out["world_size"]) for out in res.values()} == {("gloo", 2)}
    return {rank: out["cases"] for rank, out in res.items()}


@functools.lru_cache(maxsize=None)
def _jax_mesh_solve(case):
    K, mb, nb, link, seed = case
    mesh = jmesh_lib.make_mesh((2,), axis_names=("blocks",), devices=jax.devices()[:2])
    return jax_solve(jgen.block_angular_lp(K, mb, nb, link, seed=seed, sparse=False),
                     backend=jba.BlockAngularBackend(mesh=mesh), tol=1e-8)


@pytest.mark.parametrize("i", range(len(CASES)), ids=["K8", "K5-ragged"])
def test_world_of_two_matches_the_jax_mesh_solve(world2, i):
    case = CASES[i]
    K, mb, nb, link, seed = case
    rj = _jax_mesh_solve(case)
    outs = [world2[rank][i] for rank in (0, 1)]
    assert len({o["x_sha256"] for o in outs}) == 1
    Kp = K + (-K) % 2
    for o in outs:
        assert o["status"] == rj.status.value == "optimal"
        assert o["iterations"] == rj.iterations
        assert abs(o["objective"] - rj.objective) <= 1e-8 * (1 + abs(rj.objective))
        assert o["layout"][0] == Kp and o["shard_shape"][0] == Kp // 2
    # The local mesh of 2 runs the same sums in this process.
    p = tgen.block_angular_lp(K, mb, nb, link, seed=seed, sparse=False)
    mesh = mesh_lib.make_mesh(axis_names=("blocks",), devices=["cpu"] * 2)
    r = solve(p, backend=BlockAngularBackend(mesh=mesh), tol=1e-8)
    assert hashlib.sha256(np.asarray(r.x).tobytes()).hexdigest() == outs[0]["x_sha256"]
