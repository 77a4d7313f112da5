from distributedlpsolver_tpu_torch.models.problem import InteriorForm, LPProblem, to_interior_form
from distributedlpsolver_tpu_torch.models.generators import (
    BatchedLP,
    block_angular_lp,
    correlated_request_stream,
    random_batched_lp,
    random_dense_lp,
    random_general_lp,
    random_request_stream,
    random_sparse_lp,
    netlib_sparse_lp,
    sparse_request_stream,
    storm_sparse_lp,
)
from distributedlpsolver_tpu_torch.models.presolve import presolve
from distributedlpsolver_tpu_torch.models.scenario import (
    ScenarioLP,
    scenario_delta_stream,
    scenario_k_bucket,
    two_stage_storm,
)

__all__ = [
    "LPProblem", "InteriorForm", "to_interior_form",
    "random_dense_lp", "random_general_lp", "random_sparse_lp", "presolve",
    "BatchedLP", "random_batched_lp", "random_request_stream", "correlated_request_stream",
    "sparse_request_stream", "storm_sparse_lp", "netlib_sparse_lp", "block_angular_lp",
    "ScenarioLP", "two_stage_storm", "scenario_delta_stream", "scenario_k_bucket",
]
