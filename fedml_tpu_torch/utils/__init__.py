"""Host-side helpers (counterpart of ``fedml_tpu/utils``)."""
