"""Size/structure-aware backend dispatch (``--backend=auto``).

The port of the JAX package's ``backends/auto.py``. The right execution
target depends on the problem, not only the hardware: a tiny LP solves
in milliseconds on the host but pays device dispatch on the card, while
anything with real FLOPs wants the card, and block-angular or two-stage
structure wants its own tier. :func:`choose_backend_name` applies the
reference's rules once; :class:`AutoBackend` delegates every call to the
backend it picked.

The platform is the resolved torch device: ``"cpu"`` is taken only when
the caller asks for ``device="cpu"``, and routes as the reference does
there; ``"cuda"`` takes the reference's accelerator branch, which returns
``"cuda"`` (the port's dense card backend) where the reference returns
``"tpu"``. On the card the port keeps every problem on the card: where the
reference's accelerator branch sends a problem to the host (tiny ones to
``cpu-native``, sparse ones to ``cpu-sparse``), this one returns
``"cuda"`` (a deliberate deviation, ROADMAP Queue 3: on the H100 a
128×512 solve takes ~6.5× longer an iteration on ``cpu-native`` than in
the card's fused loop). Without a card and without an explicit
``device="cpu"``, :class:`AutoBackend` raises — it never takes the CPU
route because the card is missing. The backend's name is
``auto(<chosen>)``, on the result and on every record.

A problem with a ``bordered`` hint, or a sparse one of at least 20,000
rows below density 0.1, goes to the matrix-free ``sparse-iterative``
backend, on the card or (with ``device="cpu"``) on the CPU, as in the
reference. A problem with a block hint of two or more blocks, or a
sparse one whose blocks the detection pass finds, goes on the card to
the Schur backend ``block`` (``backends/block_angular.py``). A problem with
a ``two_stage`` hint, or a hint-less sparse one whose two-stage arrow the
detection pass finds, goes on both devices to the scenario-decomposed
backend ``scenario`` (``backends/scenario.py``), as in the reference.

The supervisor's degradation order lives here, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

from distributedlpsolver_tpu_torch.backends.base import (
    SolverBackend,
    get_backend,
    register_backend,
)
from distributedlpsolver_tpu_torch.backends.dense import resolve_device
from distributedlpsolver_tpu_torch.ipm.config import SolverConfig
from distributedlpsolver_tpu_torch.ipm.state import IPMState, StepStats
from distributedlpsolver_tpu_torch.models.problem import InteriorForm

# At/above this many rows a sparse problem routes to the matrix-free
# inexact-IPM backend (the reference's threshold).
_HUGE_SPARSE_ROWS = 20_000

# Supervisor degradation order (supervisor/supervisor.py): the reference's
# chain with ``cuda`` (the dense card backend) in place of ``tpu``. Each
# step trades throughput for independence from the faulting layer:
# multi-device sharding → single-card dense → matrix-free inexact IPM →
# CPU sparse-direct → plain CPU, which shares no device runtime at all.
# The supervisor takes a rung only when this package registers it, and a
# host rung only from a backend the caller placed on the CPU: on the card
# the chain is ``cuda`` → ``sparse-iterative``.
DEGRADATION_CHAIN = ("sharded", "cuda", "sparse-iterative", "cpu-sparse", "cpu")

# The backends that run on the host whatever device their caller names.
HOST_BACKENDS = frozenset({"cpu", "cpu-native", "cpu-sparse"})

# The scenario-decomposed engine degrades onto the rungs that solve its
# lowered block-angular form (on the card only ``sparse-iterative``: the
# host rungs are taken from a backend placed on the CPU alone).
_SCENARIO_CHAIN = ("sparse-iterative", "cpu-sparse", "cpu")


def degradation_chain(name: str) -> list:
    """Fallback backend names strictly *after* ``name`` in the degradation
    order. Aliases resolve through the registry ("dense" → "cuda"); names
    outside the chain ("auto", custom backends) get the full chain minus
    themselves — any rung is a degradation from a specialized or unknown
    backend."""
    from distributedlpsolver_tpu_torch.backends.base import _REGISTRY

    key = (name or "").lower()
    cls = _REGISTRY.get(key)
    primary = cls.name if cls is not None else key
    if primary == "scenario":
        return list(_SCENARIO_CHAIN)
    if primary in DEGRADATION_CHAIN:
        i = DEGRADATION_CHAIN.index(primary)
        return list(DEGRADATION_CHAIN[i + 1:])
    return [n for n in DEGRADATION_CHAIN if n != primary]


def choose_backend_name(
    inf: InteriorForm, platform: str, detect: bool = False
) -> Tuple[str, Optional[dict]]:
    """Pick a backend for ``inf``; returns ``(name, hint)``.

    ``platform`` is a torch device type (``"cuda"`` or ``"cpu"``); any
    other accelerator name takes the accelerator branch too. With
    ``detect`` (the AutoBackend path), hint-less sparse problems get a
    block-angular and a two-stage detection pass (models/structure.py); a
    successful detection is RETURNED as the hint rather than attached to
    ``inf`` — this function is pure, so callers can inspect routing
    without mutating the problem. The names it returns are the
    reference's, ported or not, with ``cuda`` for ``tpu`` and, on the
    card, for the reference's host routes."""
    import scipy.sparse as sp

    hint0 = inf.block_structure or {}
    if hint0.get("kind") == "two_stage":
        return "scenario", None
    if hint0.get("kind") == "bordered":
        return "sparse-iterative", None
    if (
        sp.issparse(inf.A)
        and inf.m >= _HUGE_SPARSE_ROWS
        and inf.A.nnz / max(inf.m * inf.n, 1) < 0.1
    ):
        return "sparse-iterative", None
    if detect and sp.issparse(inf.A) and not hint0:
        from distributedlpsolver_tpu_torch.models.structure import detect_two_stage

        ts = detect_two_stage(inf.A)
        if ts is not None:
            return "scenario", ts
    if platform == "cpu":
        return "cpu-native", None
    # The card: everything runs there, with block structure preferring
    # the Schur backend.
    m, n = inf.m, inf.n
    K = int((inf.block_structure or {}).get("num_blocks", 0))
    if K >= 2:
        return "block", None
    # A genuinely sparse problem with block structure the detection pass
    # finds goes to the Schur backend too; without it, to the card's dense
    # backend (below the sparse tier's row wall, A densified).
    if detect and sp.issparse(inf.A) and inf.A.nnz / max(m * n, 1) < 0.1:
        from distributedlpsolver_tpu_torch.models.structure import (
            detect_block_structure,
            estimate_block_tensor_entries,
        )

        hint = detect_block_structure(inf.A)
        if hint is not None and (
            estimate_block_tensor_entries(inf.A, hint) <= 1 << 28
        ):
            return "block", hint
    return "cuda", None


@register_backend("auto")
class AutoBackend(SolverBackend):
    """Delegates to the backend :func:`choose_backend_name` picks for the
    resolved device (the first CUDA card unless ``device`` names the
    CPU; without a card it raises)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._inner: Optional[SolverBackend] = None

    def setup(self, inf: InteriorForm, config: SolverConfig) -> None:
        name, hint = choose_backend_name(inf, self.device.type, detect=True)
        # An unported route raises here, naming its item, before the
        # problem is touched.
        self._inner = get_backend(name, device=self.device)
        if hint is not None:
            inf.block_structure = hint
        self.name = f"auto({name})"
        self._inner.setup(inf, config)

    @property
    def inner(self) -> Optional[SolverBackend]:
        """The backend :meth:`setup` picked (None before setup)."""
        return self._inner

    @property
    def phase_report(self):
        return getattr(self._inner, "phase_report", None)

    def starting_point(self) -> IPMState:
        return self._inner.starting_point()

    def iterate(self, state: IPMState) -> Tuple[IPMState, StepStats]:
        return self._inner.iterate(state)

    def bump_regularization(self) -> bool:
        return self._inner.bump_regularization()

    def solve_full(self, state: IPMState):
        return self._inner.solve_full(state)

    def to_host(self, state: IPMState) -> IPMState:
        return self._inner.to_host(state)

    def from_host(self, state: IPMState) -> IPMState:
        return self._inner.from_host(state)

    def block_until_ready(self, obj) -> None:
        self._inner.block_until_ready(obj)

    @property
    def mesh(self):
        return getattr(self._inner, "mesh", None) if self._inner else None

    def reshard(self, mesh):
        # The auto decision already happened at setup; a shrink re-places
        # the CHOSEN backend — the inner reshard, not a fresh AutoBackend,
        # so the new mesh is not second-guessed.
        return self._inner.reshard(mesh) if self._inner else None
