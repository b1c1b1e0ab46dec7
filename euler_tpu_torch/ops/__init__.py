"""Host-side ops (counterpart of ``euler_tpu.ops``)."""
