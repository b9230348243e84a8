"""Async event-loop support; the compiled event engine is a later slice."""

from repro_torch.el.events.knobs import default_event_horizon

__all__ = ["default_event_horizon"]
