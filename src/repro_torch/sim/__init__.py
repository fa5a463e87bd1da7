"""Simulation: the time-to-accuracy harness (``sim/tta.py``). The network
simulator ``sim/netsim.py`` waits for ROADMAP A16, A17 and A19."""
from .tta import (KeyDraws, ReplicaRun, TrainRunConfig, run_training,
                  steps_to_accuracy)

__all__ = ["KeyDraws", "ReplicaRun", "TrainRunConfig", "run_training",
           "steps_to_accuracy"]
