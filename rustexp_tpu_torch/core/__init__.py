"""See rustexp_tpu_torch/__init__.py."""
