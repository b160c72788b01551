"""The runtime knob controller of both planes: the port of
``horovod_tpu/control``'s ``ControlLoop``, ``Knob``, ``Proposal``,
``TrainingController`` and ``ServingController``.

A per-job controller changes the exchange's knobs (fusion threshold,
bucket count, wire format, ladder, mesh) while the job runs, one change at
a time, canaried against the throughput before it and rolled back on a
regression; its proposals for the continuous knobs come from the GP/EI of
``autotune.OnlineTuner``. On the port a change lands through the
``rejit`` callback, which rebuilds the optimizer and captures the CUDA
graph again (``train.TrainRecapture``). ``HOROVOD_CONTROLLER=1`` is the
master switch (``controller_enabled``); the controller itself is built
by the caller, since it needs the job's step loop. The serving
controller (``serving.py``) drives the routers' live ``ServeConfig`` from
the anomaly stream; ``maybe_start_serving_controller`` is the routers'
hook.
"""

from .core import ControlLoop, Knob, Proposal
from .serving import ServingController, maybe_start_serving_controller
from .training import TrainingController, controller_enabled

__all__ = [
    "ControlLoop",
    "Knob",
    "Proposal",
    "ServingController",
    "TrainingController",
    "controller_enabled",
    "maybe_start_serving_controller",
]
