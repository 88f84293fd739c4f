"""Serving tier: static-batch baseline, continuous-batching engine, the
scheduler-task driver, and the telemetry-driven autoscaler."""
from repro_torch.serve.autoscale import AutoscaleConfig, ServeAutoscaler
from repro_torch.serve.continuous import (Admission, ContinuousEngine,
                                          cache_batch_axes)
from repro_torch.serve.driver import ServeDriver
from repro_torch.serve.engine import (Request, ServeEngine, greedy_reference,
                                      modal_dummy_inputs, prompt_prefix_len)

__all__ = [
    "Admission", "AutoscaleConfig", "ContinuousEngine", "Request",
    "ServeAutoscaler", "ServeDriver", "ServeEngine", "cache_batch_axes",
    "greedy_reference", "modal_dummy_inputs", "prompt_prefix_len",
]
