"""The LM serving engine: slot-based continuous batching over the
port's ``Model.prefill`` and ``Model.decode_step``."""

from .engine import Request, ServeConfig, ServingEngine

__all__ = ["Request", "ServeConfig", "ServingEngine"]
