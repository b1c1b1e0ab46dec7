"""Layers, aggregators, encoders and metrics (counterpart of
``euler_tpu.nn``)."""
