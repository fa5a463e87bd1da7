"""Simulation: the time-to-accuracy harness (``sim/tta.py``) and the
calibrated cloud-network simulator (``sim/netsim.py``) that gives its steps
a wall clock."""
from .netsim import (LIBRARY_FACTOR, GAResult, GASimulator, NetworkModel,
                     fit_gilbert_elliott, simulate_job, timing_family)
from .tta import (KeyDraws, ReplicaRun, TrainRunConfig, run_training,
                  steps_to_accuracy)

__all__ = ["GAResult", "GASimulator", "KeyDraws", "LIBRARY_FACTOR",
           "NetworkModel", "ReplicaRun", "TrainRunConfig",
           "fit_gilbert_elliott", "run_training", "simulate_job",
           "steps_to_accuracy", "timing_family"]
