"""The native CPU kernels (``kernels.cpp``) of the ``cpu-native`` backend.

NOTE: do not re-export a name ``build`` here — it would shadow the
``native.build`` submodule on the package object.
"""

from distributedlpsolver_tpu_torch.native.build import NativeBuildError, load

__all__ = ["load", "NativeBuildError"]
