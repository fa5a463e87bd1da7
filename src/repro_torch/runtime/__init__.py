"""Closed-loop runtime control plane (paper §3.2, DESIGN §5).

The port's copy of ``src/repro/runtime/``: plain Python and numpy, the
same policies from the same telemetry. In the port's eager launcher a
"compiled step" is the step function ``build_train_step`` returns.

One subsystem owns every adaptive decision the sync layer makes:

    StepTelemetry  --observe-->  ControlPlane  --policy-->  SyncPolicy
    (per-peer stage times,       (UbtState controllers      (hadamard on/off,
     loss fraction, drop          + StragglerDetector)       incast I, timeout
     stats, round times)                                     x%, active peers)

The :class:`ControlPlane` is host state (an XLA fabric cannot drop or time
out; see ``core/ubt.py``): the trainer, the launcher's ``--adaptive`` loop,
and the cloud-network simulator all feed it :class:`StepTelemetry` and read
back a small hashable :class:`SyncPolicy`.  The policy's ``active_peers``
drives the degraded-participation topologies (``OptiReduceConfig
.active_peers``), and :class:`PolicyStepCache` keeps one compiled train step
per policy so an eject -> readmit cycle never recompiles.
"""
from .control import ControlPlane, PolicyStepCache, SyncPolicy
from .straggler import (ACTIVE, EJECTED, PROBATION, PeerState,
                        StragglerDetector)
from .telemetry import StepTelemetry

__all__ = [
    "StepTelemetry", "SyncPolicy", "ControlPlane", "PolicyStepCache",
    "StragglerDetector", "PeerState", "ACTIVE", "EJECTED", "PROBATION",
]
