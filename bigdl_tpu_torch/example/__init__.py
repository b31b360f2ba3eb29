"""Example applications of the port (``bigdl_tpu/example``):
``textclassification``."""
