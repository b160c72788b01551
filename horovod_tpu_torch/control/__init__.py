"""The runtime knob controller of the training side: the port of
``horovod_tpu/control``'s ``ControlLoop``, ``Knob``, ``Proposal`` and
``TrainingController``.

A per-job controller changes the exchange's knobs (fusion threshold,
bucket count, wire format, ladder, mesh) while the job runs, one change at
a time, canaried against the throughput before it and rolled back on a
regression; its proposals for the continuous knobs come from the GP/EI of
``autotune.OnlineTuner``. On the port a change lands through the
``rejit`` callback, which rebuilds the optimizer and captures the CUDA
graph again (``train.TrainRecapture``). ``HOROVOD_CONTROLLER=1`` is the
master switch (``controller_enabled``); the controller itself is built
by the caller, since it needs the job's step loop. The JAX package's
``ServingController`` waits for the port's ``serving/``.
"""

from .core import ControlLoop, Knob, Proposal
from .training import TrainingController, controller_enabled

__all__ = [
    "ControlLoop",
    "Knob",
    "Proposal",
    "TrainingController",
    "controller_enabled",
]
