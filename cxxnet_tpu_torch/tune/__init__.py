"""Self-tuning runtime: telemetry-driven knob controller.

``controller = 1`` in a conf arms a background
:class:`~cxxnet_tpu_torch.tune.controller.KnobController` for the task —
hill-climbing the runtime-adjustable knobs (decode-pool workers/window
for train, micro-batcher size/timeout + speculative bucket prewarm for
serve) toward the balance point where the host pipeline and the device
step fully overlap; ``task=loop_fleet``'s arbiter climbs each tenant's
fine-tune rounds.  The port's copy of ``cxxnet_tpu/tune/``: the
same decisions, events and gauges under the same ``tune_*`` keys.
"""

from .controller import (
    Knob,
    KnobController,
    TuneOptions,
    band_verdict,
    options_from_cfg,
    set_effective,
)
from .targets import (batcher_knobs, find_pipeline, pipeline_knobs,
                      tenant_round_knobs)

__all__ = [
    "Knob",
    "KnobController",
    "TuneOptions",
    "band_verdict",
    "options_from_cfg",
    "set_effective",
    "batcher_knobs",
    "find_pipeline",
    "pipeline_knobs",
    "tenant_round_knobs",
]
