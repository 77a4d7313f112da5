"""distributedlpsolver_tpu_torch — the LP solver ported to PyTorch and CUDA.

A second package beside the JAX one (``distributedlpsolver_tpu``), with
the same module layout and names, so each module's counterpart is found
under the same path. It imports ``torch``, numpy and scipy, and never JAX
or anything of the JAX package: the framework-free modules it needs
(problem forms, presolve, scaling, MPS I/O, checkpoints, telemetry) are
kept here as copies.

Entry points run on the first CUDA card unless the caller asks for the
CPU (``get_backend("auto", device="cpu")``, ``cli solve --device cpu``);
with no card and no such request they raise. The default backend of
the CLI and the service, ``auto``, keeps every problem on the card (on
the CPU it picks the host's native kernels, ``cpu-native``). On a CUDA
tensor the
normal-equations assembly ``A·diag(d)·Aᵀ`` runs through the hand-written
kernel ``csrc/normal_eq.cu`` (see ``ops/normal_eq.py``).
"""

from __future__ import annotations

__version__ = "0.1.0"

from distributedlpsolver_tpu_torch.models.problem import (  # noqa: E402
    InteriorForm,
    LPProblem,
    to_interior_form,
)

__all__ = [
    "LPProblem",
    "InteriorForm",
    "to_interior_form",
    "__version__",
]
